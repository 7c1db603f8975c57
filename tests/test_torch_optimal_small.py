"""The port's DP tiers on short chunks against the JAX package's.

``libdeflate_tpu_torch.compress_chunks_optfast`` on two 256-byte chunks
at 60 and 200 live bytes (one 256-position DP segment a chunk, one
candidate sort segment of 256) and ``compress_chunks_optimal_deep`` on
two 1536-byte chunks at 1536 and 1000 live bytes (a 1536-position DP
segment, as the chunk is no multiple of 1024; the rescue pass over half
segments of 768) against their XLA paths in
``libdeflate_tpu/compress/tpu_optimal.py`` under vmap; the chunks are
tests/dp_tier_cases.py's batch cut short.  The same words and
total_bits, and every fragment inflates through zlib.  Tolerance:
exact.
"""

import pytest

from dp_tier_cases import check, one_torch_thread, xla  # noqa: F401


@pytest.mark.parametrize("tier,small", [("optfast", (256, (60, 200))),
                                        ("deep", (1536, (1536, 1000)))],
                         ids=str)
def test_short_chunks_match_xla(tier, small):
    check(tier, False, xla(tier, small), small)
