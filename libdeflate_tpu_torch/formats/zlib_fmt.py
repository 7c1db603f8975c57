"""zlib container format (RFC 1950).

Header/trailer construction and validation with the same contract as the
reference wrappers (``lib/zlib_compress.c:31-82``,
``lib/zlib_decompress.c:48-87``): CM must be DEFLATE(8), CINFO <= 7, FCHECK
must validate, FDICT is rejected, and the Adler-32 trailer (big-endian) is
verified.

The port's own copy of ``libdeflate_tpu/formats/zlib_fmt.py``, whole.
"""

from __future__ import annotations

CM_DEFLATE = 8
CINFO_32K_WINDOW = 7

# FLEVEL hints (header bits 6-7 of FLG)
FASTEST_COMPRESSION = 0
FAST_COMPRESSION = 1
DEFAULT_COMPRESSION = 2
SLOWEST_COMPRESSION = 3

MIN_HEADER_SIZE = 2
FOOTER_SIZE = 4
MIN_OVERHEAD = MIN_HEADER_SIZE + FOOTER_SIZE


def level_hint(compression_level: int) -> int:
    """Map a libdeflate level (0..12) to the zlib FLEVEL header hint.

    Contract parity: lib/zlib_compress.c:47-55.
    """
    if compression_level < 2:
        return FASTEST_COMPRESSION
    if compression_level < 6:
        return FAST_COMPRESSION
    if compression_level < 8:
        return DEFAULT_COMPRESSION
    return SLOWEST_COMPRESSION


def make_header(compression_level: int) -> bytes:
    hdr = (CM_DEFLATE << 8) | (CINFO_32K_WINDOW << 12)
    hdr |= level_hint(compression_level) << 6
    hdr |= 31 - (hdr % 31)
    return hdr.to_bytes(2, "big")


def make_trailer(adler: int) -> bytes:
    return (adler & 0xFFFFFFFF).to_bytes(4, "big")


def parse_header(data: bytes) -> int | None:
    """Validate the 2-byte zlib header.  Returns 2 on success, None if bad.

    Rejects: short input, failed FCHECK, CM != 8, CINFO > 7, FDICT set
    (contract parity: lib/zlib_decompress.c:48-87).
    """
    if len(data) < MIN_HEADER_SIZE:
        return None
    hdr = int.from_bytes(data[:2], "big")
    if hdr % 31 != 0:
        return None
    if (hdr >> 8) & 0xF != CM_DEFLATE:
        return None
    if (hdr >> 12) > CINFO_32K_WINDOW:
        return None
    if (hdr >> 5) & 1:  # FDICT: preset dictionaries not supported
        return None
    return MIN_HEADER_SIZE
