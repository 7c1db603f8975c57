"""Clocks of the measurement scripts.

Host-clock times end in ``torch.cuda.synchronize()`` on a CUDA device, as
the JAX scripts end theirs by copying the result to the host.  On the CPU
they time the plain versions, which says nothing about a device.  CUDA
events around back-to-back calls measure the host's pace when a call's
launch costs more host time than its kernel takes on the card;
``graph_ms`` replays the calls from a CUDA graph, which takes the host out.
``stage_ms`` times one call both ways: on the host clock, and by CUDA
events around it with the card's queue held back by a sleep kernel until
the host has issued the whole call, so that the events see the device's
own time; the two differ where the host paces the call.
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


# cycles a millisecond of ``torch.cuda._sleep`` (the H100's 1.98 GHz
# boost clock; a slower clock only lengthens the sleep)
SLEEP_CYCLES_PER_MS = 1_980_000
MAX_SLEEP_MS = 4000.0


def stage_ms(fn, dev: torch.device, reps: int = 5):
    """(host ms, event ms) of fn(), medians of reps calls after one
    warm-up call.  Host: perf_counter around fn() and a sync.  Events: a
    sleep kernel of twice the warm-up's host time (at most MAX_SLEEP_MS)
    is queued first, then events around fn(), so the card starts the
    call's work only once the host has issued it all: the events span the
    device's time with no wait on the host, unless fn itself waits for the
    card (a copy to the host), after which the host paces it again.  None
    for the events off CUDA."""
    t0 = time.perf_counter()
    fn()
    sync(dev)
    warm = 1e3 * (time.perf_counter() - t0)
    host, events = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        host.append(1e3 * (time.perf_counter() - t0))
    if dev.type == "cuda":
        cycles = int(min(2 * warm + 1, MAX_SLEEP_MS) * SLEEP_CYCLES_PER_MS)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize(dev)
            events.append(start.elapsed_time(stop))
    return (statistics.median(host),
            statistics.median(events) if events else None)


def ms_text(ms) -> str:
    """A time of ``stage_ms`` as its lines print it."""
    return "not measured" if ms is None else f"{ms:.3f} ms"
