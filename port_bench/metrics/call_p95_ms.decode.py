"""95th percentile of the host time of the traced run's calls outside
the profiler session: the decode call's tail (its spread across runs is
too wide for an end-to-end bound)."""

from port_bench.stats import p95


def read(t, run):
    return 1e3 * p95(t.untraced_s) if t.untraced_s else None
