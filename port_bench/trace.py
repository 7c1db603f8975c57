"""The traced run's events and the arithmetic the per-layer readers share.

One ``torch.profiler`` session (CPU and CUDA) covers a fixed number of
the window's calls, each inside a ``record_function`` range named
``CALL_SPAN``: one session a process, since the profiler stops seeing
the card after a few.  Its events are read back from its Chrome trace
(written under ``TMPDIR`` and deleted at once) and kept as plain ``Ev``
tuples, so the readers and their tests need no profiler.

Device ops are kernels, copies (memcpy) and fills (memset).  A kernel is
the library's (PyTorch's or CUB's: sorts, gathers, elementwise, fills)
when its name is in one of their namespaces, and hand-written
otherwise, so a new kernel of the program counts as hand-written without
an edit here.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import NamedTuple

CALL_SPAN = "port_bench.call"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
LIBRARY_KERNEL = re.compile(r"\b(at|c10|cub|at_cuda_detail|thrust|cutlass|"
                            r"cublas|cudnn)::|gemm|xmma")


class Ev(NamedTuple):
    """One profiler event: ``kind`` is "kernel", "memcpy", "memset" (on
    ``device``, ``stream``), "cpu" (a torch op) or "span" (a
    ``record_function`` range) on thread ``stream``; times in ns."""
    name: str
    kind: str
    device: int
    stream: int
    start: int
    end: int


_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
          "cpu_op": "cpu", "user_annotation": "span",
          "cuda_runtime": "cpu", "cuda_driver": "cpu"}


def from_profiler(prof) -> list[Ev]:
    """The session's events as ``Ev``s, from its Chrome trace written to
    a temporary directory (under ``TMPDIR``) and deleted at once."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    return from_chrome(raw)


def from_chrome(raw) -> list[Ev]:
    """``Ev``s of Chrome trace events (times in us)."""
    out = []
    for e in raw:
        kind = _KINDS.get(e.get("cat", "").lower())
        if kind is None or e.get("ph") != "X":
            continue
        start = int(round(1e3 * float(e["ts"])))
        args = e.get("args") or {}
        if kind in DEVICE_KINDS:
            dev, stream = int(args.get("device", e.get("pid", 0))), int(
                args.get("stream", e.get("tid", 0)))
        else:
            dev, stream = -1, hash(e.get("tid", 0))
        out.append(Ev(e["name"], kind, dev, stream, start,
                      start + int(round(1e3 * float(e.get("dur", 0))))))
    return out


def is_library(name: str) -> bool:
    return bool(LIBRARY_KERNEL.search(name))


def union(intervals) -> int:
    """Length covered by the (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(intervals, lo: int, hi: int):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most ``width``
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void ") and "(" in name:
        name = name[5:name.index("(")]
    return name if len(name) <= width else name[:width - 3] + "..."


@dataclass
class Traced:
    """What the traced calls left: the events, the calls' spans (ns) and
    bytes, the cards used, and the seconds of the window's calls outside
    the session."""
    events: list[Ev]
    devices: list[int]
    in_bytes: int = 0           # input bytes of the traced calls
    out_bytes: int = 0          # output bytes of the traced calls
    untraced_s: list[float] = field(default_factory=list)

    def __post_init__(self):
        self.calls = sorted((e.start, e.end) for e in self.events
                            if e.kind == "span" and e.name == CALL_SPAN)

    @property
    def window(self) -> tuple[int, int]:
        return self.calls[0][0], self.calls[-1][1]

    def device_ops(self, device: int | None = None, kinds=DEVICE_KINDS):
        return [e for e in self.events if e.kind in kinds
                and (device is None or e.device == device)]

    def busy_ns(self, device: int) -> int:
        lo, hi = self.window
        return union(clip([(e.start, e.end) for e in self.device_ops(device)],
                          lo, hi))

    def busy_s(self) -> float:
        """Seconds in which an op ran on a card, averaged over the cards."""
        return sum(self.busy_ns(d) for d in self.devices) / len(
            self.devices) / 1e9

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def sum_ms(self, pick) -> float:
        """ms of device ops for which ``pick(ev)`` holds, summed."""
        return sum(e.end - e.start for e in self.device_ops() if pick(e)) / 1e6

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the device ops with the most total time."""
        tot: dict[str, int] = {}
        for e in self.device_ops():
            k = short_name(e.name)
            tot[k] = tot.get(k, 0) + e.end - e.start
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[host op, seconds]] of the longest stretches in which no card
        of the run had an op, each named by the innermost torch op or
        range that covered most of it (or the op before it)."""
        lo, hi = self.window
        ops = [(e.start, e.end) for e in self.device_ops()
               if e.device in self.devices]
        host = [e for e in self.events if e.kind in ("cpu", "span")
                and e.name != CALL_SPAN]
        found = sorted(gaps(ops, lo, hi), key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in found:
            best, key = None, None
            for h in host:
                cover = min(h.end, e) - max(h.start, s)
                if cover > 0 and (key is None
                                  or (cover, h.start - h.end) > key):
                    best, key = h.name, (cover, h.start - h.end)
            if best is None:
                before = [h for h in host if h.end <= s]
                best = ("python after " + max(before, key=lambda h: h.end).name
                        if before else "python")
            out.append([best, (e - s) / 1e9])
        return out
