"""The traced run's arithmetic on synthetic profiler events: interval
union and idle share, the window rate with its crossing call, the p95,
the roofline counts and the per-layer readers."""

import types

import pytest

from port_bench import roofline, run, stats
from port_bench.trace import CALL_SPAN, Ev, Traced, from_chrome, gaps, union

MS = 1_000_000  # ns


def ev(name, kind, start_ms, end_ms, device=0, stream=7):
    dev = device if kind in ("kernel", "memcpy", "memset") else -1
    return Ev(name, kind, dev, stream, int(start_ms * MS), int(end_ms * MS))


def traced(events, devices=(0,), in_bytes=64 << 20, out_bytes=0,
           untraced=()):
    return Traced(events, list(devices), in_bytes=in_bytes,
                  out_bytes=out_bytes, untraced_s=list(untraced))


def read(name, t, chunk=1 << 20):
    return run.metric_reader(name)(t, types.SimpleNamespace(chunk=chunk))


def test_union_merges_overlaps_and_touching():
    assert union([(0, 2), (1, 3), (3, 4), (6, 7)]) == 5
    assert union([]) == 0
    assert gaps([(1, 2), (4, 6)], 0, 8) == [(0, 1), (2, 4), (6, 8)]


def test_idle_share_over_the_window_of_the_calls():
    events = [ev(CALL_SPAN, "span", 0, 10), ev(CALL_SPAN, "span", 10, 20),
              ev("k", "kernel", 1, 4), ev("c", "memcpy", 3, 6),
              ev("k", "kernel", 12, 17), ev("late", "kernel", 25, 30)]
    t = traced(events)
    assert t.window_s() == pytest.approx(0.020)
    assert t.busy_s() == pytest.approx(0.010)
    assert read("idle_pct.compress", t) == pytest.approx(50.0)


def test_idle_share_is_the_mean_over_the_cards():
    events = [ev(CALL_SPAN, "span", 0, 10), ev("k", "kernel", 0, 10, 0),
              ev("k", "kernel", 0, 5, 1)]
    assert traced(events, devices=(0, 1)).idle_pct() == pytest.approx(25.0)


def test_window_rate_counts_the_call_that_crosses():
    calls = [(1.0, 1.4, 100, 10), (1.4, 2.0, 100, 10), (2.0, 3.5, 100, 10)]
    total, seconds = stats.window_rate(calls, 1.0, 2)
    assert (total, seconds) == (300, pytest.approx(2.5))


def test_p95_interpolates():
    assert stats.p95(range(1, 101)) == pytest.approx(95.05)
    assert stats.p95([7.0]) == 7.0
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx(4 / 4)


def test_roofline_counts():
    assert roofline.feasible_rungs(roofline.LEN_LADDER_DENSE2, 1024) == 77360
    assert len(roofline.LEN_LADDER_DENSE2) == 80
    # 64 MiB: 14 values a position at 4 bytes, bytes-bound
    n = 64 << 20
    want = 4 * (14 * n + 259 * 64) / 3.35e12
    assert roofline.dp_parse_least_s(n, 64) == pytest.approx(want)
    ops = 3 * 77360 * (n // 1024) / roofline.H100_INT32_OPS_PER_S
    assert ops < want
    assert roofline.chain_double_least_s(n) == pytest.approx(16 * n / 3.35e12)


def test_roofline_readers_and_nothing_to_read():
    k1 = "void (anonymous namespace)::dp_parse_kernel<8, Dense2, unsigned>(x)"
    least = roofline.dp_parse_least_s(64 << 20, 64)
    t = traced([ev(CALL_SPAN, "span", 0, 100),
                ev(k1, "kernel", 0, 2 * least * 1e3)])
    assert read("dp_parse_roofline", t) == pytest.approx(50.0, rel=1e-6)
    assert read("chain_double_roofline", t) is None
    c4 = "void (anonymous namespace)::chain_double_kernel<1>(y)"
    least = roofline.chain_double_least_s(64 << 20)
    t = traced([ev(CALL_SPAN, "span", 0, 100),
                ev(c4, "kernel", 0, 4 * least * 1e3)])
    assert read("chain_double_roofline", t) == pytest.approx(25.0,
                                                                 rel=1e-6)


def test_op_classes_per_MiB():
    events = [ev(CALL_SPAN, "span", 0, 100),
              ev("void at::native::vectorized_elementwise_kernel<4>(a)",
                 "kernel", 0, 3),
              ev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()",
                 "kernel", 3, 5),
              ev("Memset (Device)", "memset", 5, 6),
              ev("void (anonymous namespace)::pack_gather_kernel(b)", "kernel",
                 6, 50),
              ev("Memcpy HtoD (Pageable -> Device)", "memcpy", 50, 58)]
    t = traced(events, in_bytes=2 << 20, out_bytes=4 << 20)
    assert read("torch_ops_ms_per_MiB.compress", t) == pytest.approx(3.0)
    assert read("copy_ms_per_MiB.compress", t) == pytest.approx(4.0)
    assert read("copy_ms_per_MiB.decode", t) == pytest.approx(2.0)
    assert t.top_ops(2) == [["pack_gather_kernel", pytest.approx(0.044)],
                            ["Memcpy HtoD (Pageable -> Device)",
                             pytest.approx(0.008)]]


def test_decode_ms_a_launch_and_call_p95():
    name = "void (anonymous namespace)::decode_chunks_kernel(z)"
    t = traced([ev(CALL_SPAN, "span", 0, 100), ev(name, "kernel", 0, 40),
                ev(name, "kernel", 50, 92)],
               untraced=[0.5, 0.6, 0.7])
    assert read("decode_chunks_ms", t) == pytest.approx(41.0)
    for name in ("call_p95_ms.compress", "call_p95_ms.decode"):
        assert read(name, t) == pytest.approx(1e3 * stats.p95([0.5, 0.6, 0.7]))
        assert read(name, traced(t.events)) is None


def test_shard_spread_reads_each_cards_busiest_stream():
    events = [ev(CALL_SPAN, "span", 0, 100),
              ev("k", "kernel", 0, 60, device=0, stream=20),
              ev("gather", "memcpy", 60, 95, device=0, stream=7),
              ev("k", "kernel", 0, 70, device=1, stream=21),
              ev(CALL_SPAN, "span", 100, 200),
              ev("k", "kernel", 100, 150, device=0, stream=20),
              ev("k", "kernel", 100, 180, device=1, stream=21)]
    t = traced(events, devices=(0, 1))
    assert read("shard_spread_ms", t) == pytest.approx((10 + 30) / 2)
    assert read("shard_spread_ms", traced(events, devices=(0,))) is None


def test_idle_gaps_name_the_host_op():
    events = [ev(CALL_SPAN, "span", 0, 100),
              ev("k", "kernel", 0, 10), ev("k", "kernel", 40, 95),
              ev("aten::copy_", "cpu", 9, 45), ev("aten::to", "cpu", 8, 46),
              ev("cudaStreamSynchronize", "cpu", 96, 98)]
    gaps_ = traced(events).idle_gaps()
    assert gaps_[0] == ["aten::copy_", pytest.approx(0.030)]
    assert gaps_[1] == ["cudaStreamSynchronize", pytest.approx(0.005)]


def test_chrome_events_parse():
    raw = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 1.5, "dur": 2.0,
            "pid": 0, "tid": 7, "args": {"device": 1, "stream": 13}},
           {"ph": "X", "cat": "user_annotation", "name": CALL_SPAN,
            "ts": 1.0, "dur": 5.0, "pid": 9, "tid": 9},
           {"ph": "X", "cat": "gpu_user_annotation", "name": CALL_SPAN,
            "ts": 1.0, "dur": 5.0, "pid": 0, "tid": 7},
           {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0}]
    got = from_chrome(raw)
    assert [(e.name, e.kind, e.device, e.stream, e.start, e.end)
            for e in got[:1]] == [("k", "kernel", 1, 13, 1500, 3500)]
    assert [e.kind for e in got] == ["kernel", "span"]
