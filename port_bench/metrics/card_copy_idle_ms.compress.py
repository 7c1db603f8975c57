"""Idle ms a traced call, from the device trace, whose innermost program
span is one card's copy in (``mesh.card_in``: that card's shard of the
file issued from the pinned batch buffer) or out (``mesh.card_out``: its
kept chunks' bytes into the member buffer and the wait on them), by the
attribution of ``entry_idle_ms.compress``.  None where the traced calls
hold neither span (a program without them)."""

from port_bench.run import metric_reader

SPANS = ("mesh.card_in", "mesh.card_out")


def read(t, run):
    if not any(e.kind == "span" and e.name in SPANS for e in t.events):
        return None
    return metric_reader("entry_idle_ms.compress")(t, run, prefixes=SPANS)
