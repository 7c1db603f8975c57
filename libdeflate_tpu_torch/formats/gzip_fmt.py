"""gzip container format (RFC 1952).

Header/trailer construction and parsing with the same contract as the
reference wrappers (``lib/gzip_compress.c:31-90``,
``lib/gzip_decompress.c:31-133``): we always emit the minimal 10-byte header
(FLG=0, MTIME=0, OS=unknown, XFL by level); on decompression we accept and
skip FEXTRA/FNAME/FCOMMENT/FHCRC fields and reject FRESERVED bits.

The port's own copy of ``libdeflate_tpu/formats/gzip_fmt.py``, whole.
"""

from __future__ import annotations

ID1 = 0x1F
ID2 = 0x8B
CM_DEFLATE = 8

FTEXT = 0x01
FHCRC = 0x02
FEXTRA = 0x04
FNAME = 0x08
FCOMMENT = 0x10
FRESERVED = 0xE0

MTIME_UNAVAILABLE = 0

XFL_SLOWEST_COMPRESSION = 0x02
XFL_FASTEST_COMPRESSION = 0x04

OS_UNKNOWN = 255

MIN_HEADER_SIZE = 10
FOOTER_SIZE = 8
MIN_OVERHEAD = MIN_HEADER_SIZE + FOOTER_SIZE


def make_header(compression_level: int) -> bytes:
    """Minimal 10-byte gzip header (contract: lib/gzip_compress.c:44-64)."""
    xfl = 0
    if compression_level < 2:
        xfl |= XFL_FASTEST_COMPRESSION
    elif compression_level >= 8:
        xfl |= XFL_SLOWEST_COMPRESSION
    return bytes(
        [ID1, ID2, CM_DEFLATE, 0]
    ) + MTIME_UNAVAILABLE.to_bytes(4, "little") + bytes([xfl, OS_UNKNOWN])


def make_trailer(crc: int, isize: int) -> bytes:
    return (crc & 0xFFFFFFFF).to_bytes(4, "little") + (
        isize & 0xFFFFFFFF
    ).to_bytes(4, "little")


def parse_header(data: bytes) -> int | None:
    """Parse/validate a gzip member header; return its byte length, or None.

    Mirrors the validation order and bounds checks of
    lib/gzip_decompress.c:45-100: magic/CM check, FRESERVED rejection, then
    skipping FEXTRA, FNAME, FCOMMENT, and FHCRC while ensuring at least the
    8-byte footer remains.
    """
    n = len(data)
    if n < MIN_OVERHEAD:
        return None
    if data[0] != ID1 or data[1] != ID2 or data[2] != CM_DEFLATE:
        return None
    flg = data[3]
    if flg & FRESERVED:
        return None
    pos = MIN_HEADER_SIZE
    if flg & FEXTRA:
        if n - pos < 2:
            return None
        xlen = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if n - pos < xlen + FOOTER_SIZE:
            return None
        pos += xlen
    if flg & FNAME:
        end = data.find(b"\x00", pos)
        pos = n if end < 0 else end + 1
        if n - pos < FOOTER_SIZE:
            return None
    if flg & FCOMMENT:
        end = data.find(b"\x00", pos)
        pos = n if end < 0 else end + 1
        if n - pos < FOOTER_SIZE:
            return None
    if flg & FHCRC:
        pos += 2
        if n - pos < FOOTER_SIZE:
            return None
    return pos
