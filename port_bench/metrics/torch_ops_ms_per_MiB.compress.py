"""Device ms of every op that is neither a hand-written kernel nor a
copy (the library's sorts, gathers, elementwise kernels and fills) per
MiB of input: the tier entries and the checksums."""

from port_bench.trace import is_library

MiB = 1 << 20


def read(t, run):
    ms = t.sum_ms(lambda e: e.kind == "memset"
                  or (e.kind == "kernel" and is_library(e.name)))
    return ms / (t.in_bytes / MiB) if ms else None
