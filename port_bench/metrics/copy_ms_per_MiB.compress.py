"""Device ms of copies (the chunks to the card, the words to the host,
the gather) per MiB of input: the whole-file codec and the mesh."""

from port_bench.metrics_common import copy_ms_per_MiB


def read(t, run):
    return copy_ms_per_MiB(t, t.in_bytes)
