"""Pass 1's literal cost a row against the JAX package's Pallas path.

``libdeflate_tpu_torch.compress_chunks_optimal_pallas_with(row_lit1=
True)`` (the mean cost a 64 KiB row of the seed histogram) against
``libdeflate_tpu/compress/tpu_optimal.py::_compress_chunks_optimal_pallas``
in interpret mode, each chunk alone on the JAX side
(``dp_tier_cases.check_pallas_with``), on ``scripts/tier_matrix.py``'s
lean1XR (one pass, raw C, the dense ladder): with ``lit_sample`` 1 on
one 128 KiB chunk of text then records (two rows of different costs),
and with ``lit_sample`` 32 (one row) on tests/dp_tier_cases.py's batch
(two 64 KiB chunks, 65536 and 40000 live bytes).  Words and total_bits
exact; every fragment inflates to its chunk.
"""

import numpy as np
import torch

from dp_tier_cases import (  # noqa: F401
    N,
    P1,
    batch,
    check_pallas_with,
    one_torch_thread,
)
from libdeflate_tpu_torch.compress import optimal


def test_row_lit1_two_rows():
    bufs = batch()[0]
    one = np.concatenate([bufs[0], bufs[1]])[None].copy()
    args = (one, np.array([2 * N], np.int32), np.array([False]))
    check_pallas_with(dict(P1, row_lit1=True), args)
    # the two rows' means differ, and the flat mean is neither
    cache = optimal.literal_hist_rows(*(torch.from_numpy(x)
                                        for x in args[:2]))
    rows = optimal.mean_literal_costs(cache, 2 * N, True)[0]
    flat = optimal.mean_literal_costs(cache, 2 * N, False)[0]
    assert int(rows[0]) != int(rows[-1])
    assert int(flat[0]) not in (int(rows[0]), int(rows[-1]))


def test_row_lit1_sampled():
    check_pallas_with(dict(P1, row_lit1=True, lit_sample=32), batch())
