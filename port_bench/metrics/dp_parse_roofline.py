"""K1 (``dp_parse_kernel``): its least time for the level-6 DP over the
traced calls' input (``roofline.dp_parse_least_s``) as a share of its
device time."""

from port_bench import roofline


def read(t, run):
    ms = t.sum_ms(lambda e: e.kind == "kernel" and "dp_parse_kernel" in e.name)
    if not ms:
        return None
    chunks = -(-t.in_bytes // run.chunk)
    return 100 * 1e3 * roofline.dp_parse_least_s(t.in_bytes, chunks) / ms
