"""The port's whole-file codec at level 6 (the lean min-cost DP of mesh
levels 5-7) against the JAX package's.

``compress_chunks_dp`` in all five outputs and the file codec on the
text case of tests/file_codec_cases.py: one JAX compile of the level
(levels 8-12 are held on the card to the pinned JAX bytes, and their
chunk compressors on the CPU by tests/test_torch_optimal_levels.py and
tests/test_torch_optimal_level10.py).  Tolerance: exact.
"""

from file_codec_cases import (  # noqa: F401
    check_compress_chunks_dp,
    check_file_codec,
    one_torch_thread,
)

LEVEL = 6


def test_compress_chunks_dp_equal():
    check_compress_chunks_dp(LEVEL)


def test_file_codec_equal_on_text():
    check_file_codec("survey text", LEVEL)
