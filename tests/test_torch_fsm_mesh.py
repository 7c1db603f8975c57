"""The port's ``decompress_chunks_dp`` with ``decoder="fsm"`` and
``"auto"`` on a mesh of 8 CPU devices against the JAX package's with the
same decoder strings on its forced 8-device CPU mesh (tests/conftest.py).

On CPU devices the JAX mesh resolves "auto" to its FSM decoder
(``libdeflate_tpu/parallel/mesh.py:159-161``), and so does the port: all
five outputs (whole ``out`` rows, zeros past each out_len in both) must
be equal on valid rows, damaged rows (bit flips, a byte overwritten, cuts)
and ``out_lens`` that do not match.  Every call has B = 8 rows of NCAP
bytes and one out_cap, so the JAX mesh compiles once.

Tolerance: exact.
"""

import numpy as np
import pytest

from file_codec_cases import meshes
from libdeflate_tpu.parallel import mesh as jm
from libdeflate_tpu_torch.experiments import crafted_streams as cs
from libdeflate_tpu_torch.experiments import fsm_cases as fc
from libdeflate_tpu_torch.parallel import mesh as pm

NCAP, CHUNK, OUT_CAP = 1024, 512, 640
TEXT = cs.repo_text()


def _rows(streams, out_lens):
    bufs = np.zeros((8, NCAP), np.uint8)
    in_lens = np.zeros(8, np.int32)
    for i, s in enumerate(streams):
        bufs[i, : len(s)] = np.frombuffer(s, np.uint8)
        in_lens[i] = len(s)
    return bufs, in_lens, np.asarray(out_lens, np.int32)


def _chunks(seed: int):
    rng = np.random.default_rng(seed)
    raws = [TEXT[o:o + CHUNK] for o in rng.integers(0, len(TEXT) - CHUNK, 6)]
    raws += [rng.integers(0, 256, 300, np.uint8).tobytes(), b""]
    return raws, [cs.zlib_stream(r, 6) for r in raws]


def _case(name: str):
    raws, streams = _chunks(1)
    lens = [len(r) for r in raws]
    if name == "valid":
        return _rows(streams, lens), raws
    if name == "damaged":
        damaged = fc.damage(streams[:2], 5)
        return _rows(damaged, [CHUNK] * 8), None
    wrong = list(lens)
    wrong[1] -= 7
    wrong[6] += 1
    return _rows(streams, wrong), raws


@pytest.mark.parametrize("decoder", ["fsm", "auto"])
@pytest.mark.parametrize("case", ["valid", "damaged", "out_lens off"])
def test_fsm_and_auto_equal_jax(decoder, case):
    jmesh, pmesh = meshes()
    (bufs, in_lens, out_lens), raws = _case(case)
    got = [x.numpy() for x in pm.decompress_chunks_dp(
        pmesh, bufs, in_lens, out_lens, OUT_CAP, decoder=decoder)]
    want = [np.asarray(x) for x in jm.decompress_chunks_dp(
        jmesh, bufs, in_lens, out_lens, OUT_CAP, decoder=decoder)]
    for name, g, w in zip(("out", "out_lens", "consumed", "status",
                           "all_lens"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    out, lens, _, status, _ = got
    if case == "valid":
        assert status.tolist() == [0] * 8
        for i, raw in enumerate(raws):
            assert out[i, : lens[i]].tobytes() == raw
    elif case == "damaged":
        assert 0 < int((status != 0).sum()) < 8
    else:
        assert status[1] == 1 and status[6] == 1
        assert (status[[0, 2, 3, 4, 5, 7]] == 0).all()
