"""In-repo profiling switches.

Counterpart of ``libdeflate_tpu/utils/profiling.py``:

- ``Phase``: wall-clock phase accounting, each phase optionally ending in
  ``sync`` of the tensors it made, used by ``programs/benchmark.py
  --profile``;
- ``sync``: waits for the CUDA devices that hold the tensors of a nested
  tree (the JAX version copies the arrays to the host, its only reliable
  barrier); CPU tensors need no wait;
- ``device_trace``: a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity where CUDA is present, on every thread)
  that writes a Chrome trace into a directory given as its argument or
  by ``LIBDEFLATE_TPU_TRACE``, read at call time; a no-op without one;
- ``span`` and ``stage_marks``: the program's own ranges (the whole-file
  entry's ``codec.*``, the mesh's ``mesh.*``, the tier entries'
  ``stage.*``, the decoder's ``decode.*``), ``record_function`` ranges in
  whatever ``torch.profiler`` session the caller has started, so they
  share its clock with the kernels and copies.  With no session a span
  costs one read of the profiler's flag.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch
from torch.autograd import profiler as _autograd_profiler

# what ``span`` returns with no profiler session: reusable, allocates nothing
_NO_SPAN = contextlib.nullcontext()


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
    from torch._C._profiler import _ExperimentalConfig

    os.makedirs(trace_dir, exist_ok=True)
    # every thread's ops and ranges: a mesh of several shards runs each
    # shard in a worker thread of its own
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name: str):
    """A ``record_function`` range named ``name`` when a profiler session
    is on; otherwise a reusable no-op context (one flag read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage_marks(on_stage=None):
    """Yields the ``mark(name)`` a tier entry calls as each stage begins
    and with ``"end"`` after the last.  Each mark calls ``on_stage(name)``
    (when given), closes the open stage range and, with a profiler
    session on, opens ``stage.<name>`` (``"end"`` only closes).  Leaving
    the block, by an error too, closes the open range."""
    open_range = None

    def close():
        nonlocal open_range
        if open_range is not None:
            rng, open_range = open_range, None
            rng.__exit__(None, None, None)

    def mark(name: str) -> None:
        nonlocal open_range
        if on_stage is not None:
            on_stage(name)
        close()
        if name != "end" and _autograd_profiler._is_profiler_enabled:
            open_range = torch.profiler.record_function("stage." + name)
            open_range.__enter__()

    try:
        yield mark
    finally:
        close()
