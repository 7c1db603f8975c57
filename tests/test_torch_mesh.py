"""The port's chunk mesh (``libdeflate_tpu_torch.parallel.mesh``) against
the JAX package's ``libdeflate_tpu.parallel.mesh``.

- ``chunk_compressor`` sends every level from -1 to 13 down the branch
  of ``_chunk_compressor`` that the JAX ladder takes, with the mesh's
  keyword set (checked by which port entry and keywords it returns);
- ``compress_chunks_dp`` gives the same words, total_bits and all_bits
  on meshes of 1, 3 and 8 CPU devices;
- ``decompress_chunks_dp`` with ``decoder="pallas"`` on 8 CPU devices
  equals the JAX mesh's with the interpret-mode Pallas decoder
  (tests/test_parallel.py runs it so) in all five outputs (``out`` up to each chunk's length where it
  decodes, zeros past it in the port), on the cases of
  ``tests/test_parallel.py::TestChunkDecodeDP``: round trip, chunk
  boundary sizes, one corrupt chunk, ``out_lens`` off by 7.  The
  compressed rows are padded to one width, so that the JAX decoder
  compiles once an output size;
- the decoder choice: "fsm" decodes, "auto" is "fsm" on CPU devices and
  K3 ("pallas") on a CUDA mesh (``resolve_decoder``), and an unknown name
  raises (``tests/test_torch_fsm_mesh.py`` holds "fsm" and "auto" to the
  JAX mesh).

Tolerance: exact.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from file_codec_cases import TEXT, meshes, one_torch_thread  # noqa: F401
from libdeflate_tpu.parallel import mesh as jm
from libdeflate_tpu_torch.compress import optimal as po
from libdeflate_tpu_torch.parallel import mesh as pm

NCAP = 1024    # compressed row width of every decode case


def _port_branch(level):
    fn = pm.chunk_compressor(level)
    if isinstance(fn, functools.partial):
        assert fn.func is lt.compress_chunks_optimal_with
        (floor,) = [k for k, kw in po.MESH_LEVEL_OPTIONS.items()
                    if kw == fn.keywords]
        return f"optimal {floor}"
    return {lt.compress_chunks_static: "static",
            lt.compress_chunks_dynamic: "dynamic"}[fn]


def _jax_branch(level):
    """The JAX ladder's branch: its function, or the line of its lambda."""
    fn = jm._chunk_compressor(level)
    return fn.__name__ if fn.__name__ != "<lambda>" else \
        fn.__code__.co_firstlineno


def test_chunk_compressor_routing():
    levels = range(-1, 14)
    port = {lv: _port_branch(lv) for lv in levels}
    assert port == {lv: "static" if lv <= 0 else "dynamic" if lv < 5 else
                    "optimal 5" if lv < 8 else "optimal 8" if lv < 10 else
                    "optimal 10" for lv in levels}
    # the JAX ladder parts the levels the same way
    jax_of = {}
    for lv in levels:
        jax_of.setdefault(port[lv], set()).add(_jax_branch(lv))
    assert all(len(v) == 1 for v in jax_of.values()), jax_of
    assert jax_of["static"] == {"compress_chunk_static"}
    assert jax_of["dynamic"] == {"compress_chunk_dynamic"}
    assert len(set.union(*jax_of.values())) == 5


@pytest.mark.parametrize("level", [0, 1, 6])
def test_compress_chunks_dp_independent_of_the_mesh_size(level):
    cs, B = 2048, 24
    rng = np.random.default_rng(3)
    bufs = np.frombuffer(TEXT[: B * cs], np.uint8).reshape(B, cs).copy()
    bufs[5] = rng.integers(0, 256, cs)
    lengths = np.full(B, cs, np.int32)
    lengths[7], lengths[9], lengths[23] = 100, 0, 1
    bfinal = np.zeros(B, bool)
    bfinal[::5] = True
    outs = {n: pm.compress_chunks_dp(pm.make_chunk_mesh(["cpu"] * n), bufs,
                                     lengths, bfinal, level)
            for n in (1, 3, 8)}
    words, total_bits, crcs, adlers, all_bits = outs[1]
    assert torch.equal(all_bits, total_bits)
    for n in (3, 8):
        for a, b in zip(outs[1], outs[n]):
            assert torch.equal(a, b), n
    for i in range(B):
        stream = lt.device_stream_to_bytes(words[i], total_bits[i])
        d = zlib.decompressobj(-15)
        assert d.decompress(stream) == bufs[i, : lengths[i]].tobytes()
        assert crcs[i] == zlib.crc32(bufs[i, : lengths[i]])
        assert adlers[i] == zlib.adler32(bufs[i, : lengths[i]])


def test_mesh_shapes_are_checked():
    mesh = pm.make_chunk_mesh(["cpu"] * 3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        pm.make_chunk_mesh([])
    bufs = np.zeros((4, 64), np.uint8)
    with pytest.raises(ValueError):
        pm.compress_chunks_dp(mesh, bufs, np.zeros(4, np.int32),
                              np.ones(4, bool))
    with pytest.raises(ValueError):
        pm.decompress_chunks_dp(mesh, bufs, np.zeros(4, np.int32),
                                np.zeros(4, np.int32), 64)


def _compressed_chunks(data: bytes, chunk: int, ndev: int = 8):
    """Per-chunk zlib level-6 raw-DEFLATE streams, BFINAL on every chunk
    (``test_parallel._compressed_chunks``), in rows of NCAP bytes."""
    nchunks = max(-(-len(data) // chunk), 1)
    b = -(-nchunks // ndev) * ndev
    cbufs = np.zeros((b, NCAP), np.uint8)
    in_lens = np.zeros(b, np.int32)
    olens = np.zeros(b, np.int32)
    for i in range(b):
        seg = data[i * chunk: (i + 1) * chunk]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        f = co.compress(seg) + co.flush()
        cbufs[i, : len(f)] = np.frombuffer(f, np.uint8)
        in_lens[i], olens[i] = len(f), len(seg)
    return cbufs, in_lens, olens, nchunks


def _decode_both(cbufs, in_lens, out_lens, out_cap):
    """The port's five outputs and the JAX mesh's, as numpy arrays."""
    jmesh, pmesh = meshes()
    got = [x.numpy() for x in pm.decompress_chunks_dp(
        pmesh, cbufs, in_lens, out_lens, out_cap, decoder="pallas")]
    want = [np.asarray(x) for x in jm.decompress_chunks_dp(
        jmesh, cbufs, in_lens, out_lens, out_cap, decoder="pallas",
        interpret=True)]
    for name, g, w in zip(("out_lens", "consumed", "status", "all_lens"),
                          got[1:], want[1:]):
        assert g.shape == w.shape and np.array_equal(g, w), name
    out, lens, status = got[0], got[1], got[3]
    assert out.shape == want[0].shape
    for i in range(len(out)):
        if status[i] == 0:
            assert np.array_equal(out[i, : lens[i]], want[0][i, : lens[i]]), i
        # past out_len the reference leaves stale ring words (ROADMAP.md
        # queue 3); the port writes zeros
        assert not out[i, lens[i]:].any(), i
    return got


def _rng():
    return np.random.default_rng(0x1E35A7BD)


def test_decompress_roundtrip():
    chunk = 512
    data = (b"mesh decode roundtrip payload / " * 40
            + _rng().integers(0, 256, size=700, dtype=np.uint8).tobytes())
    cbufs, in_lens, out_lens, nchunks = _compressed_chunks(data, chunk)
    dout, dlens, consumed, status, all_lens = _decode_both(
        cbufs, in_lens, out_lens, chunk)
    for i in range(nchunks):
        lo, hi = i * chunk, min((i + 1) * chunk, len(data))
        assert status[i] == 0 and dlens[i] == hi - lo
        assert dout[i, : hi - lo].tobytes() == data[lo:hi]
    assert consumed.tolist() == in_lens.tolist()
    assert all_lens.tolist() == dlens.tolist()


@pytest.mark.parametrize("n", [8 * 256, 8 * 256 - 1, 7 * 256 + 1])
def test_decompress_chunk_boundary_sizes(n):
    chunk = 256
    data = _rng().integers(97, 105, size=n, dtype=np.uint8).tobytes()
    cbufs, in_lens, out_lens, nchunks = _compressed_chunks(data, chunk)
    dout, dlens, _, status, _ = _decode_both(cbufs, in_lens, out_lens, chunk)
    assert status[:nchunks].tolist() == [0] * nchunks
    assert b"".join(dout[i, : dlens[i]].tobytes()
                    for i in range(nchunks)) == data


def test_decompress_corrupt_chunk_isolated():
    chunk, bad = 512, 3
    data = (b"abcdefgh" * 64 * 8)[: 8 * chunk]
    cbufs, in_lens, out_lens, nchunks = _compressed_chunks(data, chunk)
    cbufs[bad, : min(8, in_lens[bad])] = 0xFF
    dout, _, _, status, _ = _decode_both(cbufs, in_lens, out_lens, chunk)
    assert status[bad] != 0
    for i in range(nchunks):
        if i != bad:
            lo, hi = i * chunk, (i + 1) * chunk
            assert status[i] == 0 and dout[i, :chunk].tobytes() == data[lo:hi]


def test_decompress_out_lens_mismatch_is_bad_data():
    chunk = 512
    data = (b"0123456789abcdef" * 32 * 8)[: 8 * chunk]
    cbufs, in_lens, out_lens, _ = _compressed_chunks(data, chunk)
    wrong = out_lens.copy()
    wrong[1] -= 7
    status = _decode_both(cbufs, in_lens, wrong, chunk)[3]
    assert status[1] == 1       # BAD_DATA
    assert status[0] == 0 and status[2] == 0


def test_decoder_choice():
    _, pmesh = meshes()
    data = (b"decoder choice " * 40)[: 8 * 64]
    args = (pmesh, *_compressed_chunks(data, 64)[:3], 64)
    fsm_out = pm.decompress_chunks_dp(*args, decoder="fsm")
    assert fsm_out[3].tolist() == [0] * 8
    assert fsm_out[0].numpy().tobytes() == data
    # "auto" on CPU devices is the FSM decoder, as the JAX "auto" is there
    for a, b in zip(pm.decompress_chunks_dp(*args, decoder="auto"),
                    fsm_out):
        assert torch.equal(a, b)
    assert pm.resolve_decoder("auto", pmesh.devices) == "fsm"
    # and K3 on a CUDA mesh, resolved without a card
    assert pm.resolve_decoder("auto", (torch.device("cuda"),)) == "pallas"
    assert pm.resolve_decoder("auto", ["cuda:0", "cpu"]) == "pallas"
    assert pm.resolve_decoder("pallas", pmesh.devices) == "pallas"
    with pytest.raises(ValueError):
        pm.decompress_chunks_dp(*args, decoder="xla")
