"""The plain reference of a gzip member: what decides that a compress
call's output is correct.

A member is correct when, by RFC 1952 and RFC 1951:
- its header parses (ID1 ID2 0x1f 0x8b, CM 8, the optional fields its
  FLG names);
- its raw-DEFLATE body inflates to exactly the input, and ends where the
  8-byte trailer begins, with nothing after the trailer;
- the trailer holds the CRC-32 of the input and its length mod 2^32.

Apart from that it must keep the chunked codec's size guarantee: no
larger than every chunk stored (a stored block of at most 65535 bytes
costs 5 bytes, and each chunk ends in a 5-byte sync-flush block), plus a
10-byte header and an 8-byte trailer.

The inflater is the standard library's zlib, which shares no code with
the program; ``inflate.py`` beside this file is a plain Python inflater
that the tests hold to it.  Nothing here imports the program.
"""

from __future__ import annotations

import struct
import zlib

FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16


def header_size(member: bytes) -> int:
    """Bytes of the member's header; raises ValueError if it does not
    parse."""
    if len(member) < 10 or member[:3] != b"\x1f\x8b\x08":
        raise ValueError("not a gzip member with CM 8")
    flg = member[3]
    if flg & 0xE0:
        raise ValueError(f"reserved FLG bits set ({flg:#x})")
    pos = 10
    if flg & FEXTRA:
        if len(member) < pos + 2:
            raise ValueError("FEXTRA past the end")
        pos += 2 + struct.unpack_from("<H", member, pos)[0]
    for bit in (FNAME, FCOMMENT):
        if flg & bit:
            end = member.find(b"\x00", pos)
            if end < 0:
                raise ValueError("unterminated FNAME or FCOMMENT")
            pos = end + 1
    if flg & FHCRC:
        pos += 2
    if pos > len(member):
        raise ValueError("header past the end")
    return pos


def stored_bound(n: int, chunk: int) -> int:
    """Largest member the chunked codec may return for n input bytes in
    chunks of ``chunk``: every chunk stored."""
    sizes = [min(chunk, n - i) for i in range(0, n, chunk)] or [0]
    return 18 + sum(5 * max(-(-s // 65535), 1) + s + 5 for s in sizes)


def check(member: bytes, data: bytes, crc: int) -> str | None:
    """None if ``member`` is a correct gzip member of ``data`` (whose
    CRC-32 is ``crc``), else why not."""
    try:
        pos = header_size(member)
    except ValueError as e:
        return f"header: {e}"
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(member[pos:], len(data) + 1)
    except zlib.error as e:
        return f"body: {e}"
    if len(out) > len(data) or d.unconsumed_tail:
        return "body inflates past the input's length"
    if not d.eof:
        return "body truncated"
    if out != data:
        at = next(i for i, (a, b) in enumerate(zip(out, data)) if a != b) \
            if len(out) == len(data) else min(len(out), len(data))
        return f"body differs from the input at byte {at}"
    trailer = d.unused_data
    if len(trailer) != 8:
        return f"{len(trailer)} bytes after the body, not an 8-byte trailer"
    got_crc, got_size = struct.unpack("<II", trailer)
    if got_crc != crc:
        return f"trailer CRC-32 {got_crc:#010x}, the input's {crc:#010x}"
    if got_size != len(data) & 0xFFFFFFFF:
        return f"trailer ISIZE {got_size}, the input's {len(data)}"
    return None


def over_bound(member: bytes, n: int, chunk: int) -> bool:
    return len(member) > stored_bound(n, chunk)
