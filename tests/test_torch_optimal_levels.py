"""The port's mesh ladder's DP levels 5-7 and 8-9 against the JAX package's.

``libdeflate_tpu_torch.compress_chunks_optimal_with`` at the keywords
of ``libdeflate_tpu/parallel/mesh.py::_chunk_compressor`` for levels
5-7 and 8-9 (device="cpu") against
``jax.vmap(_chunk_compressor(level))`` at B = 2; level 5-7 passes
``lit_sample=32``, which the XLA path ignores.
The same words and total_bits, and every fragment inflates through zlib;
the cases are tests/dp_tier_cases.py's (two 64 KiB chunks at B = 2, the
text chunk alone at B = 1).  Tolerance: exact.
"""

import pytest

from dp_tier_cases import check, one_torch_thread, xla  # noqa: F401

TIERS = ["level5", "level8"]


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_xla(tier):
    check(tier, False, xla(tier))
