"""Idle ms a traced call, from the device trace, whose innermost program
span is a tier entry's stage or a device checksum (``stage.*``), by the
attribution of ``entry_idle_ms.compress``."""

import functools

from port_bench.run import metric_reader

read = functools.partial(metric_reader("entry_idle_ms.compress"),
                         prefixes=("stage.",))
