"""Idle ms a traced decode call, from the device trace, whose innermost
program span is the mesh's (``mesh.*``) or the decoder's (``decode.*``),
by the attribution of ``entry_idle_ms.compress``: the program's share
of the call's idle, apart from the caller's copies."""

import functools

from port_bench.run import metric_reader

read = functools.partial(metric_reader("entry_idle_ms.compress"),
                         prefixes=("mesh.", "decode."))
