"""The readers of the program's spans on synthetic profiler events: the
card's idle time split by the innermost span across nested and sibling
spans and two host threads, and the host syncs inside spans."""

import types

import pytest

from port_bench import run
from port_bench.trace import CALL_SPAN, Ev, Traced

MS = 1_000_000  # ns
IDLE = ("entry_idle_ms.compress", "stage_idle_ms.compress",
        "mesh_idle_ms.decode")


def ev(name, kind, start_ms, end_ms, thread=1, device=0):
    if kind in ("kernel", "memcpy", "memset"):
        return Ev(name, kind, device, 7, int(start_ms * MS), int(end_ms * MS))
    return Ev(name, kind, -1, thread, int(start_ms * MS), int(end_ms * MS))


def read(name, events):
    t = Traced(events, [0])
    return run.metric_reader(name)(t, types.SimpleNamespace(chunk=1 << 20))


# two calls of 100 ms; the card busy 0-10, 30-40, 60-100 in the first and
# 100-190 in the second
CARD = [ev(CALL_SPAN, "span", 0, 100), ev(CALL_SPAN, "span", 100, 200),
        ev("k", "kernel", 0, 10), ev("c", "memcpy", 30, 40),
        ev("k", "kernel", 60, 100), ev("k", "kernel", 100, 190),
        ev("late", "kernel", 250, 400)]


def test_idle_goes_to_the_innermost_span_on_any_thread():
    spans = [
        # thread 1: the mesh around two stages, a gap between them
        ev("mesh.shards", "span", 5, 60), ev("stage.candidates", "span", 5, 20),
        ev("stage.costs", "span", 25, 45),
        # thread 2 starts inside stage.costs: its span is the innermost
        ev("decode.kernel", "span", 42, 55, thread=2),
        # the second call: codec.to_host after the card's last op
        ev("codec.to_host", "span", 185, 198), ev("codec.trailer", "span", 198,
                                                  199),
        # the caller's own work (no program span) 199-200
    ]
    events = CARD + spans
    # idle 10-30, 40-60 (call 1) and 190-200 (call 2)
    # 10-20 candidates, 20-25 mesh, 25-30 costs; 40-42 costs,
    # 42-55 decode.kernel, 55-60 mesh; 190-198 to_host, 198-199 trailer
    assert read("stage_idle_ms.compress", events) == pytest.approx(
        (10 + 5 + 2) / 2)
    assert read("entry_idle_ms.compress", events) == pytest.approx(
        (5 + 5 + 8 + 1) / 2)
    assert read("mesh_idle_ms.decode", events) == pytest.approx(
        (5 + 13 + 5) / 2)


def test_a_span_starting_as_its_parent_is_the_inner_one():
    events = [ev(CALL_SPAN, "span", 0, 10), ev("k", "kernel", 0, 2),
              ev("mesh.shards", "span", 2, 10), ev("stage.dp", "span", 2, 6)]
    assert read("stage_idle_ms.compress", events) == pytest.approx(4.0)
    assert read("entry_idle_ms.compress", events) == pytest.approx(4.0)


def test_spans_and_no_idle_read_zero():
    events = [ev(CALL_SPAN, "span", 0, 10), ev("k", "kernel", 0, 10),
              ev("codec.pad", "span", 0, 3), ev("stage.dp", "span", 3, 9)]
    for name in IDLE + ("host_syncs.compress",):
        assert read(name, events) == 0


@pytest.mark.parametrize("name", IDLE + ("host_syncs.compress",))
def test_no_program_span_reads_none(name):
    events = CARD + [ev("aten::to", "cpu", 10, 30),
                     ev("cudaStreamSynchronize", "cpu", 12, 13),
                     ev("port_bench.other", "span", 10, 30)]
    assert read(name, events) is None


def test_host_syncs_count_those_inside_a_span_on_their_thread():
    events = CARD + [
        ev("codec.to_host", "span", 10, 30),
        ev("stage.costs", "span", 30, 60, thread=2),
        ev("cudaStreamSynchronize", "cpu", 12, 13),          # in to_host
        ev("cudaEventSynchronize", "cpu", 31, 32, thread=2),  # in costs
        ev("cudaDeviceSynchronize", "cpu", 40, 41, thread=2),  # in costs
        ev("cudaStreamSynchronize", "cpu", 35, 36),     # thread 1: outside
        ev("cudaStreamSynchronize", "cpu", 70, 71),     # outside any span
        ev("cudaLaunchKernel", "cpu", 14, 15),          # not a sync
        ev("cudaStreamSynchronize", "cpu", 300, 301),   # after the calls
    ]
    assert read("host_syncs.compress", events) == pytest.approx(3 / 2)
