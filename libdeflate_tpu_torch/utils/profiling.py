"""In-repo profiling switches.

Counterpart of ``libdeflate_tpu/utils/profiling.py``:

- ``Phase``: wall-clock phase accounting, each phase optionally ending in
  ``sync`` of the tensors it made, used by ``programs/benchmark.py
  --profile``;
- ``sync``: waits for the CUDA devices that hold the tensors of a nested
  tree (the JAX version copies the arrays to the host, its only reliable
  barrier); CPU tensors need no wait;
- ``device_trace``: a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity where CUDA is present) that writes a Chrome
  trace into a directory given as its argument or by
  ``LIBDEFLATE_TPU_TRACE``, read at call time; a no-op without one.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def sync(tree) -> None:
    """Wait until the CUDA devices of the tensors in ``tree`` (nested
    lists, tuples and dicts; other leaves are ignored) have finished."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


class Phase:
    """Accumulating phase timer: ``with phases("parse"): ...`` then
    ``phases.report()``."""

    def __init__(self) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def __call__(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=None) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {t * 1e3:9.2f} ms  {t / total * 100:5.1f}%"
            f"  ({self.counts[name]}x)"
            for name, t in self.totals.items()
        ]
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Profile the block with ``torch.profiler`` if a directory is given
    (or by the LIBDEFLATE_TPU_TRACE environment variable) and write its
    Chrome trace there as ``trace_<pid>_<ns>.json``; yields the profiler
    (None when there is no directory, and nothing is traced)."""
    trace_dir = trace_dir or os.environ.get("LIBDEFLATE_TPU_TRACE")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
