"""The premerge's group size and the options' raising arguments against
the JAX package.

``libdeflate_tpu_torch.compress.pipeline.group_premerge(group=32, 64,
256)`` against ``libdeflate_tpu/compress/tpu_pipeline.py::
_group_premerge(group=...)`` on the emission items of
tests/test_torch_pipeline.py's text and records chunks (64 KiB), each row
as wide as ``_compress_chunks_optimal_pallas`` makes it ((capw - 1) *
group / 128 + 1), and the placed words of ``group_place`` against
``_group_place`` (at 256 the row, 90 words, is past the pack kernels'
bound).

Where the reference fails, the port raises the same class of error for
the same arguments of ``compress_chunks_optimal_pallas_with`` (against
``_compress_chunks_optimal_pallas`` in interpret mode, on one 16 KiB
chunk): a ``pm_group`` that does not divide the item stream (TypeError,
the reshape), a premerge row wider than 82 words (AssertionError,
``pack_groups_pallas``'s bound) and blocks that are not whole DP
segments (AssertionError).  Tolerance: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from dp_tier_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import bits, dynamic, kernels, pipeline
from test_torch_pipeline import _emit_items, text_chunk


@pytest.mark.parametrize("source", ["text", "records"])
@pytest.mark.parametrize("group", [32, 64, 256])
def test_group_premerge_group_sizes(source, group):
    values, nbits, offs, nwords = _emit_items(source)
    capw = (dynamic.DYN_CAPW - 1) * group // bits.GROUP + 1
    sbuf_j, gw_j = tp._group_premerge(
        jnp.asarray(values.astype(np.uint32)), jnp.asarray(nbits, jnp.int32),
        jnp.asarray(offs, jnp.int32), capw=capw, group=group)
    sbuf, gw = pipeline.group_premerge(
        *(torch.from_numpy(x.astype(np.int64))[None]
          for x in (values, nbits, offs)), capw, group)
    assert sbuf.shape == (1, len(values) // group, capw + 1)
    assert np.array_equal(sbuf[0].numpy(), np.asarray(sbuf_j).astype(np.int64))
    assert np.array_equal(gw[0].numpy(), np.asarray(gw_j))
    want = np.asarray(tp._group_place(sbuf_j, gw_j, nwords))
    got = kernels.group_place(sbuf, gw, nwords)[0].numpy()
    assert np.array_equal(got, want.astype(np.int64))


LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=to.LEN_LADDER_DENSE2,
            ext_c=False, strides2=(), lit_sample=32)


@pytest.mark.parametrize("option,error", [
    (dict(refine=0, pm_group=96), TypeError),
    (dict(refine=16, pm_group=256), AssertionError),
    (dict(refine=0, emit_blocks=32), AssertionError),
], ids=["pm_group 96", "capw + 1 = 122", "blocks of 512"])
def test_options_raise_where_the_reference_fails(option, error):
    n = 1 << 14
    args = (text_chunk(n)[None].copy(), np.array([n], np.int32),
            np.array([True]))
    fn = jax.jit(functools.partial(to._compress_chunks_optimal_pallas,
                                   interpret=True, **LEAN, **option))
    with pytest.raises(error):
        fn(*(jnp.asarray(x) for x in args))
    with pytest.raises(error):
        lt.compress_chunks_optimal_pallas_with(*args, device="cpu", **LEAN,
                                               **option)


def test_pack_groups_row_bound():
    sbuf = torch.zeros(1, 2, kernels.PACK_MAX_CAPW1 + 1, dtype=torch.int64)
    with pytest.raises(AssertionError):
        kernels.pack_groups(sbuf, torch.zeros(1, 2, dtype=torch.int64), 200)
    with pytest.raises(AssertionError):
        from libdeflate_tpu.compress.pallas_kernels import pack_groups_pallas
        pack_groups_pallas(jnp.asarray(sbuf.numpy().astype(np.uint32)),
                           jnp.zeros((1, 2), jnp.int32), 200, interpret=True)
    ok = kernels.pack_groups(sbuf[..., :-1], torch.zeros(1, 2,
                                                         dtype=torch.int64),
                             200)
    assert ok.shape == (1, 200)
