"""Pass 1's literal cost a chunk, and lcp 8, against the JAX package's
Pallas path.

``libdeflate_tpu_torch.compress_chunks_optimal_pallas_with(flat_lit1=
True)`` on ``scripts/tier_matrix.py``'s leanI (leanD: no content pass,
16-byte payloads, the ``LEN_LADDER_DENSE`` ladder, two cost passes; pass
1 at the chunk's mean literal cost) against
``libdeflate_tpu/compress/tpu_optimal.py::_compress_chunks_optimal_pallas``
in interpret mode, each chunk alone on the JAX side
(``dp_tier_cases.check_pallas_with``), on tests/dp_tier_cases.py's batch
(two 64 KiB chunks, 65536 and 40000 live bytes); and ``lcp8`` (8-byte
position-pass payloads) on lean1X8 (one pass, raw C, the 80-rung
ladder).  Words and total_bits exact; every fragment inflates to its
chunk.
"""

from dp_tier_cases import (  # noqa: F401
    LEAN_D,
    P1,
    batch,
    check_pallas_with,
    one_torch_thread,
)


def test_flat_lit1():
    check_pallas_with(dict(LEAN_D, flat_lit1=True), batch())


def test_lcp8():
    check_pallas_with(dict(P1, lcp8=True), batch())
