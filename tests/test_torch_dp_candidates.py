"""The DP tiers' candidate generation against the JAX package's.

``libdeflate_tpu_torch.compress.pipeline.parse_candidates`` against
``libdeflate_tpu/compress/tpu_pipeline.py::_parse_candidates`` under
vmap, in the four configurations the entries use: the lean one (lean,
optfast, level 5-7: no content pass, 16-byte payloads, raw C, one
relaxation round, 128 KiB windows), the defaults (optimal, optimal2,
level 8-9: the content pass, 32-byte payloads, C relaxed, two rounds),
deep's (depth 12, the rescue pass, hash3, 64 KiB windows, two
suffix-rank doublings in the content pass) and level 10-12's (deep's
without the doublings).  All nine outputs equal on
tests/dp_tier_cases.py's batch (two 64 KiB chunks, 65536 and 40000 live
bytes) and on the same chunks at 511 and 4095 live bytes.  Level
10-12's configuration also runs on one 128 KiB row of a 20000-byte
period of the text, two 64 KiB segments, where only the rescue pass
gives the second segment's first positions their matches.  The options
that only ``scripts/`` uses (lcp 8 and 12, the content pass's round
probes) are held in tests/test_torch_options_candidates.py.  Tolerance:
exact.
"""

import pytest

from dp_tier_cases import (  # noqa: F401
    CANDIDATE_LENGTHS,
    CANDIDATES,
    N,
    check_candidates,
    one_torch_thread,
)


@pytest.mark.parametrize("lengths", CANDIDATE_LENGTHS, ids=str)
@pytest.mark.parametrize("config", list(CANDIDATES))
def test_parse_candidates(config, lengths):
    check_candidates(config, lengths)


def test_rescue_pass_across_segments():
    check_candidates("level10", (2 * N - 1,), one_row=True)
