"""K3 (``decode_chunks_kernel``): device ms a launch."""


def read(t, run):
    runs = [e.end - e.start for e in t.device_ops(kinds=("kernel",))
            if "decode_chunks_kernel" in e.name]
    return sum(runs) / len(runs) / 1e6 if runs else None
