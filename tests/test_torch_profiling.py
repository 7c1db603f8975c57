"""The port's ``utils/profiling.py`` against the JAX package's
``libdeflate_tpu/utils/profiling.py``.

- ``Phase``: the same recorded phases (names, counts and times set
  directly, so that no clock differs) give the same totals, counts and
  ``report`` text;
- ``device_trace`` writes a Chrome trace into a given directory, or into
  the one ``LIBDEFLATE_TPU_TRACE`` names (read at call time), on the CPU,
  and does nothing without one; the trace holds every thread's ranges, so
  a two-shard mesh's two worker threads each show their tier stages;
- ``sync`` walks nested lists, tuples and dicts of tensors and other
  leaves.
"""

import io
import json

import numpy as np
import torch

from libdeflate_tpu.utils import profiling as jprof
from libdeflate_tpu_torch.parallel import mesh as pm
from libdeflate_tpu_torch.utils import profiling as prof

RECORDS = [("compress", 0.0123), ("decompress", 0.5), ("compress", 0.25),
           ("verify", 0.0), ("a phase with a long name here", 1.75)]


def _set(mod):
    phases = mod.Phase()
    for name, _ in RECORDS:
        with phases(name, sync_tree=[torch.zeros(1)] if mod is prof
                    else None):
            pass
    totals = {}
    for name, dt in RECORDS:
        totals[name] = totals.get(name, 0.0) + dt
    for name in phases.totals:
        phases.totals[name] = totals[name]
    return phases


def test_phase_equals_jax():
    got, want = _set(prof), _set(jprof)
    assert list(got.totals.items()) == list(want.totals.items())
    assert list(got.counts.items()) == list(want.counts.items())
    assert got.counts["compress"] == 2
    out_g, out_w = io.StringIO(), io.StringIO()
    assert got.report(out_g) == want.report(out_w)
    assert out_g.getvalue() == out_w.getvalue() != ""
    assert prof.Phase().report() == jprof.Phase().report() == ""


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("LIBDEFLATE_TPU_TRACE", raising=False)
    bufs = np.frombuffer(b"the shard's stages " * 200, np.uint8)[
        :2 * 1024].reshape(2, 1024)
    with prof.device_trace(str(tmp_path / "given")) as p:
        torch.arange(1000).sum()
        pm.compress_chunks_dp(pm.make_chunk_mesh(["cpu"] * 2), bufs,
                              np.full(2, 1024, np.int32), np.ones(2, bool),
                              level=0)
    assert p is not None
    (trace,) = (tmp_path / "given").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    # each shard thread's stage ranges
    threads = {e["tid"] for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "stage.candidates"}
    assert len(threads) == 2
    assert {e["name"] for e in events if e.get("tid") in threads
            and e["name"].startswith("stage.")} >= {
        "stage.candidates", "stage.commit", "stage.pack", "stage.crc32"}
    # the environment knob, read when the context is entered
    monkeypatch.setenv("LIBDEFLATE_TPU_TRACE", str(tmp_path / "env"))
    with prof.device_trace():
        torch.ones(10).cumsum(0)
    assert len(list((tmp_path / "env").glob("trace_*.json"))) == 1
    monkeypatch.delenv("LIBDEFLATE_TPU_TRACE")
    with prof.device_trace() as p:
        pass
    assert p is None
    assert sorted(x.name for x in tmp_path.iterdir()) == ["env", "given"]


def test_sync_accepts_nested_trees():
    t = torch.arange(4)
    tree = {"a": [t, (t, {"b": t})], "c": 3, "d": None, "e": "text"}
    prof.sync(tree)
    prof.sync([])
    prof.sync(t)
    assert prof._cuda_devices(tree, set()) == set()
