"""C4 (``chain_double_kernel``): its least time for one candidate's
stride-8 doubling over the traced calls' input
(``roofline.chain_double_least_s``) as a share of its device time."""

from port_bench import roofline


def read(t, run):
    ms = t.sum_ms(lambda e: e.kind == "kernel"
                  and "chain_double_kernel" in e.name)
    if not ms:
        return None
    return 100 * 1e3 * roofline.chain_double_least_s(t.in_bytes) / ms
