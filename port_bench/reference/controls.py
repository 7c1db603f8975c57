"""The controls: the reference put in the program's place, with one
guarantee of the configuration broken the way a later change might be
tempted to break it.  Each must come out as not correct.

- Compress: each chunk compressed alone by zlib at the configuration's
  level, sync-flushed (the last one finished) and joined, as the program
  joins its fragments; but the chunks' CRC-32s are combined by XOR, the
  cheap step in place of the CRC-32 combine.  The body is right, the
  trailer wrong.
- Decode: ``inflate.inflate(stream, split=half a chunk)``, the
  speculative decoder of a chunk's second half without its window.  It
  reports every chunk whole (status 0, full length, every byte
  consumed), so only the bytes can tell.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import Executor

import numpy as np

from .inflate import inflate


def _fragment(chunk: bytes, level: int, last: bool) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(chunk) + c.flush(zlib.Z_FINISH if last
                                       else zlib.Z_SYNC_FLUSH)


def gzip_xor_crc(data: bytes, chunk: int, level: int, pool: Executor) -> bytes:
    """A gzip member of ``data`` whose trailer combines the chunks'
    CRC-32s by XOR."""
    chunks = [data[i:i + chunk] for i in range(0, len(data), chunk)] or [b""]
    last = len(chunks) - 1
    frags = pool.map(lambda ic: _fragment(ic[1], level, ic[0] == last),
                     enumerate(chunks))
    crc = 0
    for ch in chunks:
        crc ^= zlib.crc32(ch)
    header = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
    return header + b"".join(frags) + struct.pack("<II", crc,
                                                  len(data) & 0xFFFFFFFF)


def _split_row(args) -> bytes:
    stream, out_cap = args
    return inflate(stream, split=out_cap // 2)


def decode_split(streams: list[bytes], out_cap: int, pool: Executor):
    """(out uint8[B, out_cap], out_lens, consumed, status) as the
    speculative decoder reports them."""
    rows = list(pool.map(_split_row, [(s, out_cap) for s in streams]))
    out = np.zeros((len(rows), out_cap), np.uint8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.frombuffer(r[:out_cap], np.uint8)
    lens = np.array([len(r) for r in rows], np.int32)
    consumed = np.array([len(s) for s in streams], np.int32)
    return out, lens, consumed, np.zeros(len(rows), np.int32)
