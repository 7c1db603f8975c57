"""Host syncs a traced call: the CUDA runtime's synchronize calls
(stream, device, event) that start inside one of the port's program
spans (``codec.*``, ``mesh.*``, ``stage.*``, ``decode.*``) on their own
host thread, over the traced calls, divided by their count.  They catch
the syncs that torch ops hide (masking, ``nonzero``,
``repeat_interleave``) as well as ``.item()`` and ``.cpu()``.  None with
no program span in the traced calls."""

PROGRAM = ("codec.", "mesh.", "stage.", "decode.")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def read(t, run):
    spans = [e for e in t.events
             if e.kind == "span" and e.name.startswith(PROGRAM)]
    syncs = [e for e in t.events
             if e.kind == "cpu" and e.name.startswith(SYNCS)]
    found, count = False, 0
    for lo, hi in t.calls:
        mine = [sp for sp in spans if sp.start < hi and sp.end > lo]
        found = found or bool(mine)
        count += sum(1 for e in syncs if lo <= e.start < hi and any(
            sp.stream == e.stream and sp.start <= e.start < sp.end
            for sp in mine))
    return count / len(t.calls) if found else None
