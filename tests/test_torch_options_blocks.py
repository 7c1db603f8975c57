"""Multi-block emission against the JAX package's.

``libdeflate_tpu_torch.compress.dynamic.emit_dynamic_pre_blocks`` against
``libdeflate_tpu/compress/tpu_dynamic.py::_emit_dynamic_pre_blocks``
(2 and 4 blocks, 0 and 16 refinement passes): the entry stream (val, nb,
offs: a 339-item header, the body and an EOB a block, padded to a
multiple of 128 items only) and aux, on the commit arrays the JAX lean
parse gives tests/test_torch_dynamic.py's five 64 KiB chunks (text, noisy
records, zeros, random bytes, text cut to 40 000 bytes), batched; then
each stream's bits placed by the group premerge and ``group_place`` and
finished by ``emit_dynamic_post``, against the JAX package's, and
inflated by zlib to its chunk.  ``dyn_nwords(n, blocks)`` against
``_dyn_nwords``.  Tolerance: exact.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_tier_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import dynamic, kernels, pipeline
from test_torch_dynamic import CHUNKS, N, jax_commit

KINDS = list(CHUNKS)


@functools.lru_cache(maxsize=None)
def commits():
    """The JAX lean parse's commit arrays of every chunk, [5, N] each."""
    return [np.stack(a) for a in zip(*(jax_commit(k) for k in KINDS))]


@pytest.mark.parametrize("refine", [0, 16])
@pytest.mark.parametrize("blocks", [2, 4])
def test_emit_dynamic_pre_blocks(blocks, refine):
    arrs = commits()
    pre = jax.jit(jax.vmap(functools.partial(
        td._emit_dynamic_pre_blocks, n_pad=N, blocks=blocks,
        refine_passes=refine)))
    (val_j, nb_j, offs_j), aux_j = pre(*[jnp.asarray(a) for a in arrs])
    t = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                          else a) for a in arrs]
    (val, nb, offs), aux = dynamic.emit_dynamic_pre_blocks(*t, blocks,
                                                           refine)
    ent = blocks * (339 + N // blocks + 1)
    assert val.shape == (len(KINDS), ent + (-ent) % 128)
    for name, g, w in zip("val nb offs".split(), (val, nb, offs),
                          (val_j, nb_j, offs_j)):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)), \
            name
    for name, g, w in zip("hdr44 eob_code eob_len hdr_bits body_bits".split(),
                          aux, aux_j):
        assert np.array_equal(g.numpy(), np.broadcast_to(
            np.asarray(w).astype(np.int64), g.shape)), name

    # the finished fragments: premerge (capw as the DP path sets it),
    # placement and the tail, each against the JAX package's
    capw = max(td.DYN_CAPW_DEEP if refine else td.DYN_CAPW, 58)
    nwords = td._dyn_nwords(N, blocks)
    bfinal = np.array([True, False, True, False, True])
    finish = jax.jit(jax.vmap(lambda v, b, o, a, f: td._emit_dynamic_post(
        tp._group_place(*tp._group_premerge(v, b, o, capw=capw), nwords),
        a, f)))
    w_j, t_j = finish(val_j, nb_j, offs_j, aux_j, jnp.asarray(bfinal))
    sbuf, gw = pipeline.group_premerge(val, nb, offs, capw)
    w, t = dynamic.emit_dynamic_post(
        kernels.group_place(sbuf, gw, nwords), aux, torch.from_numpy(bfinal))
    assert np.array_equal(t.numpy(), np.asarray(t_j))
    assert np.array_equal(w.numpy(), np.asarray(w_j).astype(np.int64))
    for k, kind in enumerate(KINDS):
        b, length = CHUNKS[kind]
        stream = pipeline.device_stream_to_bytes(w[k], t[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            b[:length].tobytes(), kind


def test_dyn_nwords_blocks():
    for n in (1, 511, 4096, 65536, 40000, 1 << 20, (1 << 20) + 3):
        for blocks in (1, 2, 4, 8, 30):
            assert dynamic.dyn_nwords(n, blocks) == td._dyn_nwords(n, blocks)
    assert dynamic.dyn_nwords(N) == td._dyn_nwords(N)


@pytest.mark.parametrize("blocks", [3, 128])
def test_blocks_not_of_whole_segments_raise(blocks):
    arrs = commits()
    with pytest.raises(AssertionError):
        td._emit_dynamic_pre_blocks(*[jnp.asarray(a[0]) for a in arrs], N,
                                    blocks)
    t = [torch.from_numpy(a[:1].astype(np.int64)) for a in arrs]
    with pytest.raises(AssertionError):
        dynamic.emit_dynamic_pre_blocks(*t, blocks)
