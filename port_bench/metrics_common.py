"""What several per-layer readers (``metrics/<name>.py``) share."""

from __future__ import annotations

MiB = 1 << 20


def idle_pct(t, run):
    """% of the traced window with no op on a card, over the cards."""
    return t.idle_pct() if t.device_ops() else None


def copy_ms_per_MiB(t, nbytes: int):
    ms = t.sum_ms(lambda e: e.kind == "memcpy")
    return ms / (nbytes / MiB) if ms else None


def shard_spread_ms(t, run):
    """ms from the first card's shard end to the last card's, averaged
    over the traced calls (None on one card)."""
    if len(t.devices) < 2:
        return None
    spreads = []
    for lo, hi in t.calls:
        ends = []
        for d in t.devices:
            streams: dict[int, list] = {}
            for e in t.device_ops(d):
                if lo <= e.start < hi:
                    streams.setdefault(e.stream, []).append(e)
            if not streams:
                return None
            busiest = max(streams.values(),
                          key=lambda es: sum(e.end - e.start for e in es))
            ends.append(max(e.end for e in busiest))
        spreads.append(max(ends) - min(ends))
    return sum(spreads) / len(spreads) / 1e6
