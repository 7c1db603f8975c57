"""The content pass's round probes against the JAX package.

``libdeflate_tpu_torch.compress.pipeline.parse_candidates(use_content=
True, content_round_probes=True)`` after one and two suffix-rank
doublings against ``libdeflate_tpu/compress/tpu_pipeline.py::
_parse_candidates`` under vmap (run op by op), all nine outputs, on
tests/dp_tier_cases.py's batch (two 64 KiB chunks, 65536 and 40000 live
bytes) and on the same chunks at 511 and 4095 live bytes: each round's
order is probed with 16-byte payloads and its two pools are merged into
the final one by the reference's rule (``tpu_pipeline.py:463-527``),
kept as it is.  The option changes the candidates only with the content
pass and at least one doubling; without round probes the same batch
gives other candidates.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from dp_tier_cases import (  # noqa: F401
    CANDIDATE_LENGTHS,
    OPTION_CANDIDATES,
    batch,
    check_candidates,
    one_torch_thread,
)
from libdeflate_tpu_torch.compress import pipeline


@pytest.mark.parametrize("lengths", CANDIDATE_LENGTHS, ids=str)
@pytest.mark.parametrize("config", [c for c in OPTION_CANDIDATES
                                    if "round_probes" in c])
def test_parse_candidates_round_probes(config, lengths):
    got = check_candidates(config, lengths)
    if lengths == CANDIDATE_LENGTHS[0]:
        plain = dict(OPTION_CANDIDATES[config], content_round_probes=False)
        base = pipeline.parse_candidates(torch.from_numpy(batch()[0].copy()),
                                         torch.tensor(lengths), **plain)
        assert any(not np.array_equal(a.numpy(), b.numpy())
                   for a, b in zip(got, base))
