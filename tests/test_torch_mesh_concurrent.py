"""The chunk mesh runs its shards at once (``parallel/mesh.py``), and the
host state that its worker threads share is safe for threads.

- Shards run at once: on ``["cpu"] * n`` for n = 2, 4 and 8, the level's
  chunk compressor and each decoder's ``decompress_chunks`` are wrapped
  with a ``threading.Barrier(n)``, which only passes when every shard is
  inside at the same time (run in turn, it breaks: checked here too).
  Each shard runs in a worker thread of its own, and the outputs equal
  the one-shard mesh's (which ``tests/test_torch_mesh.py`` and
  ``test_torch_file_codec*.py`` hold to the JAX 8-device mesh) and the
  input bytes.
- A shard that raises makes the call raise that error, the first in
  shard order, once every worker has ended; no worker is alive after.
- ``_build.kernel`` asked for one function by eight threads at once
  starts one build and returns one function object (the build and the
  library load faked); ``_build.count_launch`` counts exactly under
  eight threads; ``_build.launch_context`` refuses tensors that are not
  on one CUDA device.
- The checksums leave ``allow_tf32`` as the caller set it, also while
  other threads run them, and ``checksums._matrices`` copies a device's
  tables once under eight threads.
- The default mesh is every CUDA device.

The batch is ``tests/file_codec_cases.py``'s B = 8 x 16 KiB; no JAX call
is made here.  Tolerance: exact.
"""

import contextlib
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from file_codec_cases import CS, dp_batch, one_torch_thread  # noqa: F401
from libdeflate_tpu_torch import _build
from libdeflate_tpu_torch.decompress import decode, fsm
from libdeflate_tpu_torch.ops import checksums
from libdeflate_tpu_torch.parallel import mesh as pm

LEVEL = 1          # dyn1, the flagship chunk compressor
WAIT_S = 60        # a barrier's timeout: shards in turn would wait it out


def _at_the_barrier(fn, n: int, names: list, timeout: float = WAIT_S):
    """fn behind a barrier of n parties, noting each caller's thread."""
    barrier = threading.Barrier(n, timeout=timeout)

    def wrapped(*args, **kwargs):
        names.append(threading.current_thread().name)
        barrier.wait()
        return fn(*args, **kwargs)
    return wrapped


def _one_thread_a_shard(names: list, n: int) -> None:
    assert len(names) == n and len(set(names)) == n
    assert all(name.startswith("chunk-shard") for name in names)


def _shard_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("chunk-shard")]


_reference: dict = {}


def _one_shard(direction: str):
    """The one-shard mesh's outputs (run once a file)."""
    if direction not in _reference:
        mesh = pm.make_chunk_mesh(["cpu"])
        _reference[direction] = (
            pm.compress_chunks_dp(mesh, *dp_batch(), level=LEVEL)
            if direction == "compress" else
            pm.decompress_chunks_dp(mesh, *_streams(), CS,
                                    decoder=direction))
    return _reference[direction]


def _streams():
    """zlib level-6 raw-DEFLATE streams of dp_batch's chunks, BFINAL on
    each: (bufs uint8 [8, width], in_lens, out_lens)."""
    bufs, lengths, _ = dp_batch()
    streams = []
    for row, n in zip(bufs, lengths):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        streams.append(co.compress(row[:n].tobytes()) + co.flush())
    out = np.zeros((len(streams), max(map(len, streams)) + 64), np.uint8)
    for i, s in enumerate(streams):
        out[i, : len(s)] = np.frombuffer(s, np.uint8)
    return out, np.array(list(map(len, streams)), np.int32), lengths


@pytest.mark.parametrize("n", [2, 4, 8])
def test_compress_shards_run_at_once(n, monkeypatch):
    want = _one_shard("compress")
    names = []
    compressor = pm.chunk_compressor
    monkeypatch.setattr(pm, "chunk_compressor", lambda level: _at_the_barrier(
        compressor(level), n, names))
    got = pm.compress_chunks_dp(pm.make_chunk_mesh(["cpu"] * n), *dp_batch(),
                                level=LEVEL)
    _one_thread_a_shard(names, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not _shard_threads()


@pytest.mark.parametrize("decoder,module", [("pallas", decode),
                                            ("fsm", fsm)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_decode_shards_run_at_once(n, decoder, module, monkeypatch):
    want = _one_shard(decoder)
    names = []
    monkeypatch.setattr(module, "decompress_chunks", _at_the_barrier(
        module.decompress_chunks, n, names))
    bufs, in_lens, out_lens = _streams()
    got = pm.decompress_chunks_dp(pm.make_chunk_mesh(["cpu"] * n), bufs,
                                  in_lens, out_lens, CS, decoder=decoder)
    _one_thread_a_shard(names, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out, lens, consumed, status, _ = got
    raw, lengths, _ = dp_batch()
    assert status.tolist() == [0] * 8 and lens.tolist() == lengths.tolist()
    assert consumed.tolist() == in_lens.tolist()
    for i in range(8):
        assert out[i, : lengths[i]].numpy().tobytes() == \
            raw[i, : lengths[i]].tobytes()


def test_the_barrier_breaks_in_turn():
    """The harness's own check: two shards called in turn break it."""
    wrapped = _at_the_barrier(lambda: None, 2, [], timeout=0.2)
    with pytest.raises(threading.BrokenBarrierError):
        for _ in range(2):
            wrapped()


def test_a_shard_error_is_raised_once_every_shard_ends(monkeypatch):
    """Shards 1 and 3 of four raise, shard 3 first in time; the others
    take longer than both.  The call raises shard 1's error, after the
    others have finished, and leaves no worker alive."""
    finished = []

    def compressor(level):
        def shard(bufs, lengths, bfinal, device=None):
            k = int(bufs[0, 0])
            if k == 3:
                raise ValueError("shard 3 fails")
            time.sleep(0.3 if k == 1 else 0.6)
            if k == 1:
                raise ValueError("shard 1 fails")
            finished.append(k)
            return (torch.zeros(len(bufs), 4, dtype=torch.int32),
                    torch.zeros(len(bufs), dtype=torch.int64))
        return shard

    monkeypatch.setattr(pm, "chunk_compressor", compressor)
    bufs = np.repeat(np.arange(4, dtype=np.uint8), 64).reshape(4, 64)
    with pytest.raises(ValueError, match="shard 1 fails"):
        pm.compress_chunks_dp(pm.make_chunk_mesh(["cpu"] * 4), bufs,
                              np.full(4, 64, np.int32), np.ones(4, bool))
    assert sorted(finished) == [0, 2]
    assert not _shard_threads()


def _together(n: int, fn) -> list:
    """fn() in n threads started at one barrier; their results."""
    barrier = threading.Barrier(n, timeout=WAIT_S)
    results = [None] * n

    def run(i):
        barrier.wait()
        results[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


@contextlib.contextmanager
def _switch_often():
    """Threads switch every microsecond: unguarded shared state races."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


def test_eight_threads_start_one_build(monkeypatch):
    builds, opens = [], []

    class Lib:
        def __init__(self, path):
            opens.append(path)
            self.dp_parse_launch = type("Fn", (), {})()

    def build(names):
        builds.append(tuple(names))
        time.sleep(0.2)               # an nvcc run, which others must await
        return {}

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    sig = [_build.PTR, _build.INT, _build.PTR]
    with _switch_often():
        fns = _together(8, lambda: _build.kernel("dp_parse",
                                                 "dp_parse_launch", sig))
    assert builds == [("dp_parse",)] and len(opens) == 1
    assert all(fn is fns[0] for fn in fns)
    assert fns[0].argtypes == sig


def test_count_launch_is_exact_under_eight_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    per = 20000

    def count():
        for _ in range(per):
            _build.count_launch(wrapper)

    with _switch_often():
        _together(8, count)
    assert wrapper.launches == 8 * per


def test_launch_context_wants_one_cuda_device():
    cpu = torch.zeros(2)
    for tensors in ((cpu,), (cpu, torch.zeros(2, device="meta"))):
        with pytest.raises(ValueError, match="one CUDA device"):
            with _build.launch_context(tensors, "probe"):
                pass


@pytest.mark.parametrize("caller", [False, True])
def test_checksums_leave_allow_tf32(caller):
    """The caller's allow_tf32 stays as it set it, read by the caller
    while eight threads run both checksums' products, and each checksum
    equals zlib's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = caller
    try:
        bufs, lengths, _ = dp_batch()
        stop = threading.Event()
        seen = set()

        def read():
            while not stop.is_set():
                seen.add(torch.backends.cuda.matmul.allow_tf32)

        def sums():
            return (checksums.crc32_chunks(bufs, lengths, device="cpu"),
                    checksums.adler32_chunks(bufs, lengths, device="cpu"))

        reader = threading.Thread(target=read)
        reader.start()
        try:
            with _switch_often():
                outs = _together(8, sums)
        finally:
            stop.set()
            reader.join()
        assert seen == {caller}
        assert torch.backends.cuda.matmul.allow_tf32 is caller
        want = ([zlib.crc32(r[:n]) for r, n in zip(bufs, lengths)],
                [zlib.adler32(r[:n]) for r, n in zip(bufs, lengths)])
        assert all([c.tolist(), a.tolist()] == list(want) for c, a in outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_checksum_tables_copied_once_under_eight_threads(monkeypatch):
    monkeypatch.setattr(checksums, "_on_device", {})
    with _switch_often():
        mats = _together(8, lambda: checksums._matrices(torch.device("cpu")))
    assert all(m is mats[0] for m in mats)
    assert list(checksums._on_device) == [torch.device("cpu")]


def test_default_mesh_is_every_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pm.make_chunk_mesh().devices == tuple(
        torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert pm.make_chunk_mesh(["cuda", "cuda:0"]).devices == (
        torch.device("cuda", 2), torch.device("cuda", 0))
