"""The DP candidates' options that only ``scripts/`` uses, against the
JAX package.

``libdeflate_tpu_torch.compress.pipeline.parse_candidates`` against
``libdeflate_tpu/compress/tpu_pipeline.py::_parse_candidates`` under vmap
(run op by op), all nine outputs, on tests/dp_tier_cases.py's batch (two
64 KiB chunks, 65536 and 40000 live bytes) and on the same chunks at 511
and 4095 live bytes:

``lcp`` 8 and 12 on the lean configuration (no content pass, the packed
candidate C) and ``lcp`` 8 on the defaults (the content pass, wide
payloads): the position pass sorts 8-byte payloads.  ``lcp`` 12 gives
``lcp`` 8's candidates, as in the reference, which keeps its deep
payloads only when both w8 and w12 are present (``tpu_pipeline.py:210``,
``:1141-1143``).  The content pass's round probes are in
tests/test_torch_options_probes.py.  Tolerance: exact.
"""

import numpy as np
import pytest

from dp_tier_cases import (  # noqa: F401
    CANDIDATE_LENGTHS,
    OPTION_CANDIDATES,
    check_candidates,
    one_torch_thread,
)


@pytest.mark.parametrize("lengths", CANDIDATE_LENGTHS, ids=str)
@pytest.mark.parametrize("config", [c for c in OPTION_CANDIDATES
                                    if "lcp" in c])
def test_parse_candidates_option(config, lengths):
    check_candidates(config, lengths)


@pytest.mark.parametrize("lengths", CANDIDATE_LENGTHS, ids=str)
def test_lcp12_gives_lcp8s_candidates(lengths):
    got8 = check_candidates("lean+lcp8", lengths)
    got12 = check_candidates("lean+lcp12", lengths)
    for a, b in zip(got8, got12):
        assert np.array_equal(a.numpy(), b.numpy())
