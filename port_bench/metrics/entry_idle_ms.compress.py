"""Idle ms a traced call, from the device trace, whose innermost program
span is the whole-file entry's (``codec.*``) or the mesh's (``mesh.*``).

The attribution the other idle readers share (``read`` with their
``prefixes``): in each traced call, every stretch in which no op ran on
any of the run's cards goes to the innermost program span covering it
on any host thread, the latest-starting one; each group is summed over
the traced calls and divided by their count.  A program span is one of
the port's ``record_function`` ranges (``PROGRAM``); with none in the
traced calls (a program without them) the reader gives None, and with
spans but no idle 0.
"""

from port_bench.trace import gaps

PROGRAM = ("codec.", "mesh.", "stage.", "decode.")


def _innermost(spans, s: int, e: int, prefixes) -> int:
    """ns of [s, e] whose innermost covering span's name starts with one
    of ``prefixes``."""
    inside = [sp for sp in spans if sp.start < e and sp.end > s]
    cuts = sorted({s, e} | {x for sp in inside for x in (sp.start, sp.end)
                            if s < x < e})
    got = 0
    for a, b in zip(cuts, cuts[1:]):
        cover = [sp for sp in inside if sp.start <= a and sp.end >= b]
        if cover and max(cover, key=lambda sp: (sp.start, -sp.end)
                         ).name.startswith(prefixes):
            got += b - a
    return got


def read(t, run, prefixes=("codec.", "mesh.")):
    ops = [(e.start, e.end) for e in t.device_ops() if e.device in t.devices]
    spans = [e for e in t.events
             if e.kind == "span" and e.name.startswith(PROGRAM)]
    found, idle = False, 0
    for lo, hi in t.calls:
        mine = [sp for sp in spans if sp.start < hi and sp.end > lo]
        found = found or bool(mine)
        idle += sum(_innermost(mine, s, e, prefixes)
                    for s, e in gaps(ops, lo, hi))
    return idle / len(t.calls) / 1e6 if found else None
