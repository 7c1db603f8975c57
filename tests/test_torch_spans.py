"""The port's own profiler ranges (``utils.profiling.span`` and
``stage_marks``) on the CPU.

- Under a ``torch.profiler`` session, ``gzip_compress_dp`` on a one-CPU
  mesh at levels 6 and 1 gives the whole-file entry's, the mesh's and
  the tier entry's ranges, nested and in order: the stage ranges follow
  the ``on_stage`` marks, and there is one ``codec.stored`` a chunk that
  fell back to a stored block; ``codec.grow`` opens inside ``codec.pad``
  (the batch buffer) and ``codec.to_host`` (the member buffer) on the
  thread's first call and not on a second call of the same size;
- on meshes of one and two devices, ``mesh.card_in`` and
  ``mesh.card_out`` open once a device, inside ``mesh.inputs`` and
  ``codec.to_host`` on the calling thread;
- with no session nothing enters ``record_function``, and ``on_stage``
  callers get the marks they always got;
- a one-shard mesh runs its shard on the calling thread, with the
  outputs of a two-shard mesh;
- a stage that raises leaves no range open.

Two chunks of a quarter of ``file_codec_cases.CS`` (4 KiB): text, and
random bytes, which take the stored fallback at every level.
"""

import functools
import json
import threading
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from file_codec_cases import CS, TEXT, one_torch_thread  # noqa: F401
from libdeflate_tpu_torch.compress import dynamic, pipeline
from libdeflate_tpu_torch.parallel import file_codec
from libdeflate_tpu_torch.parallel import mesh as pm
from libdeflate_tpu_torch.utils.profiling import span, stage_marks

# a quarter of the codec tests' chunk: a level-6 call on the CPU runs
# ~280 000 torch ops at 16 KiB, and a session's trace of them takes ~5 s
CHUNK = CS // 4
DATA = TEXT[:CHUNK] + np.random.default_rng(7).integers(
    0, 256, CHUNK, dtype=np.uint8).tobytes()
PROGRAM = ("codec.", "mesh.", "stage.", "decode.")
# the call's ranges outside the mesh's shards, in order
OUTER = ["codec.pad", "mesh.inputs", "mesh.card_in", "mesh.shards",
         "codec.to_host", "mesh.card_out", "codec.fragments",
         "codec.trailer", "codec.trailer"]


def _spans(prof, tmp_path):
    """The program's ranges of a session, from its Chrome trace (quicker
    than ``prof.events()`` over a level-6 call's ~280 000 CPU ops):
    [(name, thread, start, end)] by start, times in us."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return sorted(((e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(PROGRAM)),
                  key=lambda s: (s[2], -s[3]))


def _inside(inner, outer) -> bool:
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


@pytest.mark.parametrize("level", [6, 1])
def test_compress_spans_nest_in_order(level, monkeypatch, tmp_path):
    monkeypatch.setattr(file_codec, "_assembly", threading.local())
    marks, stored = [], []
    compressor = pm.chunk_compressor
    monkeypatch.setattr(pm, "chunk_compressor", lambda lv: functools.partial(
        compressor(lv), on_stage=marks.append))
    real_stored = file_codec.stored_fragment

    def counted(chunk, bfinal):
        stored.append(len(chunk))
        return real_stored(chunk, bfinal)
    monkeypatch.setattr(file_codec, "stored_fragment", counted)
    mesh = pm.make_chunk_mesh(["cpu"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        member = file_codec.gzip_compress_dp(DATA, mesh, CHUNK, level)
    assert zlib.decompress(member, 31) == DATA
    assert stored == [CHUNK]

    spans = _spans(prof, tmp_path)
    assert len({s[1] for s in spans}) == 1       # all on the caller's thread
    (shards,) = [s for s in spans if s[0] == "mesh.shards"]
    (fragments,) = [s for s in spans if s[0] == "codec.fragments"]
    (to_host,) = [s for s in spans if s[0] == "codec.to_host"]
    (pad,) = [s for s in spans if s[0] == "codec.pad"]
    stages = [s for s in spans if s[0].startswith("stage.")]
    inner = [s for s in spans if s[0] == "codec.stored"]
    grow = [s for s in spans if s[0] == "codec.grow"]
    assert [s[0] for s in spans if s not in stages + inner + grow] == OUTER
    assert [s[0] for s in stages] == [f"stage.{m}" for m in marks
                                      if m != "end"] + ["stage.crc32",
                                                        "stage.adler32"]
    assert marks[0] == "candidates" and marks[-5:] == [
        "emit_pre", "premerge", "pack", "post", "end"]
    assert ("costs" in marks and "dp" in marks) == (level == 6)
    assert all(_inside(s, shards) for s in stages)
    assert all(a[3] <= b[2] for a, b in zip(stages, stages[1:]))
    assert len(inner) == len(stored) == 1 and _inside(inner[0], fragments)
    # the batch buffer's and the member buffer's first allocations
    assert len(grow) == 2 and _inside(grow[0], pad) and _inside(grow[1],
                                                                to_host)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert file_codec.gzip_compress_dp(DATA, mesh, CHUNK, level) == member
    names = [s[0] for s in _spans(prof, tmp_path)
             if not s[0].startswith("stage.")]
    assert "codec.grow" not in names and len(stored) == 2
    assert [n for n in names if n != "codec.stored"] == OUTER


@pytest.mark.parametrize("ndev", [1, 2])
def test_card_ranges_open_once_a_device(ndev, tmp_path):
    mesh = pm.make_chunk_mesh(["cpu"] * ndev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        member = file_codec.gzip_compress_dp(DATA, mesh, CHUNK, 1)
    assert zlib.decompress(member, 31) == DATA
    spans = _spans(prof, tmp_path)
    caller = next(s[1] for s in spans if s[0] == "codec.pad")
    for name, outer in (("mesh.card_in", "mesh.inputs"),
                        ("mesh.card_out", "codec.to_host")):
        (around,) = [s for s in spans if s[0] == outer]
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == ndev and around[1] == caller
        assert all(_inside(s, around) for s in mine)
    assert not [s for s in spans if s[0] == "mesh.gather"]


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler session")


def test_no_session_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    mesh = pm.make_chunk_mesh(["cpu"])
    member = file_codec.gzip_compress_dp(DATA, mesh, CHUNK, 1)
    assert zlib.decompress(member, 31) == DATA
    assert span("codec.pad") is span("stage.x")      # one shared no-op
    seen = []
    with stage_marks(seen.append) as mark:
        mark("a")
        mark("end")
    assert seen == ["a", "end"]
    bufs = np.frombuffer(DATA, np.uint8).reshape(2, CHUNK)
    for entry in (dynamic.compress_chunks_dynamic,
                  pipeline.compress_chunks_static):
        marks = []
        entry(bufs, np.full(2, CHUNK, np.int32), np.array([0, 1], bool),
              device="cpu", on_stage=marks.append)
        assert marks == ["candidates", "commit", "emit_pre", "premerge",
                         "pack", "post", "end"]


def _shard_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("chunk-shard")]


@pytest.mark.parametrize("direction", ["compress", "decode"])
def test_one_shard_runs_on_the_calling_thread(direction, monkeypatch):
    bufs = np.frombuffer(DATA, np.uint8).reshape(2, CHUNK)
    lengths, bfinal = np.full(2, CHUNK, np.int32), np.array([0, 1], bool)
    streams = []
    for row in bufs:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        streams.append(co.compress(row.tobytes()) + co.flush())
    packed = np.zeros((2, max(map(len, streams)) + 64), np.uint8)
    for i, s in enumerate(streams):
        packed[i, : len(s)] = np.frombuffer(s, np.uint8)
    in_lens = np.array(list(map(len, streams)), np.int32)

    def call(devices):
        mesh = pm.make_chunk_mesh(devices)
        if direction == "compress":
            return pm.compress_chunks_dp(mesh, bufs, lengths, bfinal,
                                         level=1)
        return pm.decompress_chunks_dp(mesh, packed, in_lens, lengths,
                                       CHUNK)

    seen = []
    real_call = pm._shard_call

    def noted(*args):
        seen.append((threading.current_thread(), _shard_threads()))
        return real_call(*args)
    monkeypatch.setattr(pm, "_shard_call", noted)
    one = call(["cpu"])
    assert seen == [(threading.current_thread(), [])]
    two = call(["cpu", "cpu"])
    assert len(seen) == 3 and all(t.name.startswith("chunk-shard")
                                  for t, _ in seen[1:])
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    if direction == "decode":
        assert one[3].tolist() == [0, 0]
        assert [one[0][i].numpy().tobytes() for i in range(2)] == [
            row.tobytes() for row in bufs]


class _Recorder:
    """A stand-in for ``record_function`` that notes every enter and exit."""

    log: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.log.append(("enter", self.name))
        return self

    def __exit__(self, *exc):
        self.log.append(("exit", self.name))


@pytest.mark.parametrize("raises_in", ["commit", "on_stage"])
def test_a_stage_that_raises_leaves_no_range_open(raises_in, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", _Recorder)
    monkeypatch.setattr(_Recorder, "log", [])

    def fail(*args, **kwargs):
        raise RuntimeError("the stage fails")
    on_stage = None
    if raises_in == "commit":
        monkeypatch.setattr(dynamic, "commit_items", fail)
    else:
        def on_stage(name):
            if name == "commit":
                fail()
    bufs = np.frombuffer(DATA[:CHUNK], np.uint8).reshape(1, CHUNK)
    with pytest.raises(RuntimeError, match="the stage fails"):
        dynamic.compress_chunks_dynamic(bufs, np.array([CHUNK], np.int32),
                                        np.ones(1, bool), device="cpu",
                                        on_stage=on_stage)
    want = ["stage.candidates"] + ["stage.commit"] * (raises_in == "commit")
    assert _Recorder.log == [(kind, name) for name in want
                             for kind in ("enter", "exit")]


def test_a_raising_stage_closes_its_range_in_the_session(monkeypatch,
                                                        tmp_path):
    def fail(*args, **kwargs):
        raise RuntimeError("the stage fails")
    monkeypatch.setattr(dynamic, "commit_items", fail)
    bufs = np.frombuffer(DATA[:CHUNK], np.uint8).reshape(1, CHUNK)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            dynamic.compress_chunks_dynamic(bufs, np.array([CHUNK], np.int32),
                                            np.ones(1, bool), device="cpu")
        with span("codec.after"):
            pass
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["stage.candidates", "stage.commit",
                                     "codec.after"]
    assert spans[1][3] <= spans[2][2]
