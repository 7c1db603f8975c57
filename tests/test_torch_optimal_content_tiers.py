"""The port's optimal DP tier (content pass, one cost pass) against the
JAX package's.

``libdeflate_tpu_torch.compress_chunks_optimal`` (device="cpu") against
``libdeflate_tpu/compress/tpu_optimal.py::compress_chunks_optimal`` (XLA,
B = 2) and ``compress_chunks_optimal_pallas`` in interpret mode (B = 1).
The same words and total_bits, and every fragment inflates through zlib;
the cases are tests/dp_tier_cases.py's (two 64 KiB chunks at B = 2, the
text chunk alone at B = 1).  Tolerance: exact.
"""

import pytest

from dp_tier_cases import check, one_torch_thread, pallas, xla  # noqa: F401

TIERS = ["optimal"]


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_xla(tier):
    check(tier, False, xla(tier))


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_pallas_interpret_at_b1(tier):
    check(tier, True, pallas(tier))
