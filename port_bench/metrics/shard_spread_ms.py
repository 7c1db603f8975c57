"""Across cards: ms from the first card's end of its shard to the last
card's, averaged over the traced calls.  A card's shard ends with the
last op of its busiest stream in the call (the shard's own stream; the
gather runs on the caller's)."""

from port_bench.metrics_common import shard_spread_ms as read  # noqa: F401
