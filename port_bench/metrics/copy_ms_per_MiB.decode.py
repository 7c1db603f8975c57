"""Device ms of copies (the streams to the card, the outputs back) per
MiB of output: the mesh's decode."""

from port_bench.metrics_common import copy_ms_per_MiB


def read(t, run):
    return copy_ms_per_MiB(t, t.out_bytes)
