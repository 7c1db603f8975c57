"""The DEFLATE (RFC 1951) stored block type and the compressed-size bound.

The port's own copy of the part of ``libdeflate_tpu/formats/deflate.py``
that the whole-file codec uses: the stored block type (line 21) and
``deflate_compress_bound`` with its ``MIN_BLOCK_LENGTH`` (lines 238-246,
contract parity with ``libdeflate_deflate_compress_bound``).
The decoder's tables are ``decompress/tables.py``.
"""

from __future__ import annotations

BLOCKTYPE_UNCOMPRESSED = 0

MIN_BLOCK_LENGTH = 5000


def deflate_compress_bound(in_nbytes: int) -> int:
    """Worst-case DEFLATE output size: 5 bytes/block overhead + payload."""
    max_blocks = max((in_nbytes + MIN_BLOCK_LENGTH - 1) // MIN_BLOCK_LENGTH, 1)
    return 5 * max_blocks + in_nbytes
