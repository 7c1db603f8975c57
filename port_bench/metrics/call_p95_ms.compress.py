"""95th percentile of the host time of the traced run's calls outside
the profiler session: the whole-file entry's tail."""

from port_bench.stats import p95


def read(t, run):
    return 1e3 * p95(t.untraced_s) if t.untraced_s else None
