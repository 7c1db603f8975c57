"""Device ms a traced call of copies between cards: the profiler names a
copy whose source and destination are memory of two different cards
``Memcpy PtoP`` (a copy within one card is ``Memcpy DtoD``).  The mesh's
gather of the shards' words onto the lead card made such copies; with
device ops but no such copy the reader gives 0, and None with no device
op at all."""

PEER = "Memcpy PtoP"


def read(t, run):
    if not t.device_ops():
        return None
    return t.sum_ms(lambda e: e.kind == "memcpy"
                    and e.name.startswith(PEER)) / len(t.calls)
