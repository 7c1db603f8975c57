"""The port's ``Compressor`` against the JAX package's on larger inputs.

The companion of ``tests/test_torch_host_engine.py`` (same rule: the bytes
of ``libdeflate_tpu_torch.Compressor(level)`` equal those of
``libdeflate_tpu.Compressor(level)``, with both packages on the native
codec, then both on the forced Python path) on the inputs that cost the
Python path seconds: 8 KiB at the near-optimal levels 10-12, the
litrunlen-overflow input of ``tests/test_roundtrip.py`` (70000 random
bytes, more literals than one block's run counter holds) and a 320 KB
multi-block input.  Tolerance: exact.
"""

import numpy as np
import pytest

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from libdeflate_tpu import native_backend as jnb
from libdeflate_tpu_torch import native_backend as nb
from libdeflate_tpu_torch.experiments import host_contract as hc
from libdeflate_tpu_torch.experiments.corpus import make_corpus

CORPUS = make_corpus(2 << 20)
U = len(CORPUS) // 8
TEXT, SKEW, RECS = CORPUS[:2 * U], CORPUS[2 * U:4 * U], CORPUS[4 * U:6 * U]
BACKENDS = ("native", "python")


def on(backend: str):
    """Both packages on ``backend`` for the block."""
    return hc.on_backend(backend, nb, jnb)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", [10, 11, 12])
def test_near_optimal_equal_on_8k(backend, level):
    data = TEXT[20000:20000 + 4096] + SKEW[:2048] + RECS[:2048]
    with on(backend):
        assert lt.Compressor(level).deflate_compress(data) == \
            ld.Compressor(level).deflate_compress(data)


def _litrunlen_input() -> bytes:
    # tests/test_roundtrip.py::test_litrunlen_overflow's input: the first
    # draw of the suite's rng fixture
    rng = np.random.default_rng(0x1E35A7BD)
    return rng.integers(0, 256, size=70000, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", [1, 2, 6])
def test_litrunlen_overflow_equal(backend, level):
    data = _litrunlen_input()
    with on(backend):
        assert lt.Compressor(level).deflate_compress(data) == \
            ld.Compressor(level).deflate_compress(data)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", [1, 6, 9])
def test_multi_block_equal(backend, level):
    # past SOFT_MAX_BLOCK_LENGTH (300000) of text turning into skewed bytes
    data = TEXT[-200000:] + SKEW[:120000]
    with on(backend):
        out = lt.Compressor(level).deflate_compress(data)
        assert out == ld.Compressor(level).deflate_compress(data)
        assert lt.Decompressor().deflate_decompress(
            out, len(data), True)[1] == data
