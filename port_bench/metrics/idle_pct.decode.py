"""Share of the traced window in which no op ran on the card (decode)."""

from port_bench.metrics_common import idle_pct as read  # noqa: F401
