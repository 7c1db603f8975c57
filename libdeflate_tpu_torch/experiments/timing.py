"""Clocks of the measurement scripts.

Host-clock times end in ``torch.cuda.synchronize()`` on a CUDA device, as
the JAX scripts end theirs by copying the result to the host.  On the CPU
they time the plain versions, which says nothing about a device.  CUDA
events around back-to-back calls measure the host's pace when a call's
launch costs more host time than its kernel takes on the card;
``graph_ms`` replays the calls from a CUDA graph, which takes the host out.
"""

from __future__ import annotations

import statistics
import time

import torch


def describe(dev: torch.device) -> str:
    """The device a measurement ran on, as its lines name it."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return f"{dev} (plain versions; no device time)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_times(fn, dev: torch.device, reps: int) -> list[float]:
    """Seconds of fn() on the host clock, reps times after one warm-up
    call, each ending in a sync."""
    fn()
    sync(dev)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def best_of(fn, dev: torch.device, reps: int = 5) -> float:
    return min(host_times(fn, dev, reps))


def median_of(fn, dev: torch.device, reps: int = 3) -> float:
    return statistics.median(host_times(fn, dev, reps))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card: reps calls captured in one
    CUDA graph, one replay timed by CUDA events.  fn must launch on the
    current stream and allocate through PyTorch (as the wrappers do)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
