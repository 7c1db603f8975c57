"""Share of the traced window in which no op ran on a card, averaged
over the cards (the compress cells)."""

from port_bench.metrics_common import idle_pct as read  # noqa: F401
