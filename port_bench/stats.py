"""The window's arithmetic: rates, percentiles and spreads."""

from __future__ import annotations

import statistics


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics
    (``statistics.quantiles``, inclusive); one value is its own."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def window_rate(calls, start: float, key: int) -> tuple[float, float]:
    """(sum of field ``key`` of every call, the window's seconds): the
    window runs from ``start`` to the end of its last call, the one that
    crossed the length asked for, so no call is dropped or cut.  A call
    is (t0, t1, input bytes, output bytes)."""
    seconds = calls[-1][1] - start
    return sum(c[key] for c in calls), seconds


def spread(values) -> float:
    """Distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
