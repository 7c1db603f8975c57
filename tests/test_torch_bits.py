"""The port's 32-bit word helpers against the JAX package's.

libdeflate_tpu_torch/compress/bits.py (with le32_words) against
libdeflate_tpu/compress/tpu_pipeline.py (_rev16, _rev, _bsr,
_length_slot, _offset_slot, _le32_words).  Inputs are exhaustive ranges
or numpy-seeded bytes.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import bits


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_rev16_all_values():
    x = np.arange(1 << 16, dtype=np.int64)
    want = _np(tp._rev16(jnp.asarray(x, jnp.uint32)))
    assert np.array_equal(bits.rev16(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("nbits", [0, 1, 5, 11, 15, 16])
def test_rev_within_nbits(nbits):
    x = np.arange(1 << 16, dtype=np.int64)
    nb = np.full_like(x, nbits)
    want = _np(tp._rev(jnp.asarray(x, jnp.uint32), jnp.asarray(nb)))
    got = bits.rev(torch.from_numpy(x), torch.from_numpy(nb)).numpy()
    assert np.array_equal(got, want)


def test_bsr():
    x = np.concatenate([np.arange(-3, 70000), 2 ** np.arange(31) - 1,
                        2 ** np.arange(31)]).astype(np.int64)
    want = _np(tp._bsr(jnp.asarray(x, jnp.int32)))
    assert np.array_equal(bits.bsr(torch.from_numpy(x)).numpy(), want)


def test_length_slot_3_to_258():
    x = np.arange(3, 259, dtype=np.int64)
    want = [_np(v) for v in tp._length_slot(jnp.asarray(x, jnp.int32))]
    got = [v.numpy() for v in bits.length_slot(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_offset_slot_1_to_32768():
    x = np.arange(1, 32769, dtype=np.int64)
    want = [_np(v) for v in tp._offset_slot(jnp.asarray(x, jnp.int32))]
    got = [v.numpy() for v in bits.offset_slot(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("extra_pad", [4, 32])
def test_le32_words(extra_pad):
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, 4099, dtype=np.uint8)
    want = _np(tp._le32_words(jnp.asarray(b), extra_pad=extra_pad))
    got = bits.le32_words(torch.from_numpy(b)[None])[0].numpy()
    assert np.array_equal(got, want)


def test_i32_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.int64)
    t = bits.to_i32(torch.from_numpy(x))
    assert t.dtype == torch.int32
    assert np.array_equal(t.numpy().view(np.uint32), x.astype(np.uint32))
    assert np.array_equal(bits.from_i32(t).numpy(), x)
