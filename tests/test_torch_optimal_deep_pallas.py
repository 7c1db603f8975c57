"""The port's deep DP tier against its Pallas twin.

``libdeflate_tpu_torch.compress_chunks_optimal_deep`` (device="cpu")
against ``libdeflate_tpu/compress/tpu_optimal.py::
compress_chunks_optimal_deep_pallas`` in interpret mode (B = 1).
The same words and total_bits, and every fragment inflates through zlib;
the cases are tests/dp_tier_cases.py's (two 64 KiB chunks at B = 2, the
text chunk alone at B = 1).  Tolerance: exact.
"""

import pytest

from dp_tier_cases import check, one_torch_thread, pallas  # noqa: F401

TIERS = ["deep"]


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_pallas_interpret_at_b1(tier):
    check(tier, True, pallas(tier))
