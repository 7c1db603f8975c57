"""The port's whole-file codec at level 1 (dynamic Huffman, dyn1) against
the JAX package's.

As tests/test_torch_file_codec.py, at level 1: ``compress_chunks_dp`` in
all five outputs and ``gzip/zlib_compress_dp`` (and
``deflate_compress_dp`` on four cases) on every case of
tests/file_codec_cases.py.  Tolerance: exact.
"""

import pytest

from file_codec_cases import (  # noqa: F401
    CASES,
    check_compress_chunks_dp,
    check_file_codec,
    one_torch_thread,
)

LEVEL = 1


def test_compress_chunks_dp_equal():
    check_compress_chunks_dp(LEVEL)


@pytest.mark.parametrize("case", CASES)
def test_file_codec_equal(case):
    check_file_codec(case, LEVEL)
