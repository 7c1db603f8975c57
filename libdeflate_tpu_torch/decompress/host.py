"""Host whole-buffer DEFLATE decompressor.

Behavioral parity with ``libdeflate_deflate_decompress_ex``
(``lib/deflate_decompress.c:1133-1153`` + ``lib/decompress_template.h``):

- one-shot, stops after the BFINAL block
- known-size mode (must fill the output buffer exactly, else SHORT_OUTPUT)
  vs unknown-size mode
- bounded implicit-zero overread (consumed bits must all be real input;
  cf. overread_count checks at lib/deflate_decompress.c:247-249 and
  decompress_template.h:754)
- byte-aligned ``actual_in`` (unconsumed whole bytes in the bit buffer are
  rewound)
- exact-count precode RLE expansion, repeat-at-start rejected, and the
  zlib-compatible incomplete-code rules (via huffman/decode_table.py)

This host path is the framework's correctness anchor and differential oracle
glue; the device decoder (decompress/tpu.py) reuses the same packed tables.

The port's own copy of ``libdeflate_tpu/decompress/host.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import (
    BLOCKTYPE_DYNAMIC_HUFFMAN,
    BLOCKTYPE_STATIC_HUFFMAN,
    BLOCKTYPE_UNCOMPRESSED,
    NUM_LITLEN_SYMS,
    NUM_OFFSET_SYMS,
    OFFSET_SLOT_BASE,
    PRECODE_LENS_PERMUTATION,
    STATIC_LITLEN_LENS,
    STATIC_OFFSET_LENS,
)
from ..huffman.decode_table import (
    KIND_EOB,
    KIND_LITERAL,
    KIND_MATCH,
    KIND_SUBTABLE,
    LITLEN_TABLEBITS,
    OFFSET_TABLEBITS,
    PRECODE_TABLEBITS,
    build_litlen_table,
    build_offset_table,
    build_precode_table,
)

SUCCESS = 0
BAD_DATA = 1
SHORT_OUTPUT = 2
INSUFFICIENT_SPACE = 3

_MAX_OVERREAD = 8  # bytes of implicit zeros, like sizeof(bitbuf)

_STATIC_LITLEN_TABLE = build_litlen_table(STATIC_LITLEN_LENS)
_STATIC_OFFSET_TABLE = build_offset_table(STATIC_OFFSET_LENS)
_OFFSET_BASES = [int(x) for x in OFFSET_SLOT_BASE]


class _Bits:
    """LSB-first bit reader with bounded implicit-zero overread."""

    __slots__ = ("data", "n", "pos", "bitbuf", "bitsleft", "overread")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.bitbuf = 0
        self.bitsleft = 0
        self.overread = 0

    def refill(self) -> bool:
        """Top up to >= 56 bits; False if overread budget exhausted."""
        while self.bitsleft < 56:
            if self.pos < self.n:
                take = min(8, self.n - self.pos, (64 - self.bitsleft) >> 3)
                if take <= 0:
                    break
                self.bitbuf |= int.from_bytes(
                    self.data[self.pos : self.pos + take], "little"
                ) << self.bitsleft
                self.pos += take
                self.bitsleft += take << 3
            else:
                self.overread += 1
                if self.overread > _MAX_OVERREAD:
                    return False
                self.bitsleft += 8  # implicit zero byte
        return True

    def ensure(self, nbits: int) -> bool:
        if self.bitsleft < nbits:
            return self.refill()
        return True

    def pop(self, nbits: int) -> int:
        v = self.bitbuf & ((1 << nbits) - 1)
        self.bitbuf >>= nbits
        self.bitsleft -= nbits
        return v

    def align_to_byte(self) -> None:
        """Discard partial-byte bits and rewind unconsumed whole bytes."""
        self.bitsleft -= self.bitsleft & 7
        self.bitbuf &= (1 << self.bitsleft) - 1
        rewind = (self.bitsleft >> 3) - self.overread
        self.pos -= max(rewind, 0)
        self.bitbuf = 0
        self.bitsleft = 0
        self.overread = 0

    def all_consumed_bits_real(self) -> bool:
        return self.overread * 8 <= self.bitsleft

    def consumed_bytes(self) -> int:
        """Input bytes consumed, byte-aligned (reference rewind rule)."""
        return self.pos - ((self.bitsleft >> 3) - self.overread)


def _decode_sym(bits: _Bits, table: np.ndarray, table_bits: int) -> int:
    """Decode one codeword; returns the packed entry (consume applied)."""
    entry = int(table[bits.bitbuf & ((1 << table_bits) - 1)])
    if entry >> 30 == KIND_SUBTABLE:
        start = (entry >> 16) & 0x3FFF
        sub_bits = (entry >> 8) & 0xFF
        entry = int(
            table[start + ((bits.bitbuf >> table_bits) & ((1 << sub_bits) - 1))]
        )
    n = entry & 0xFF
    bits.bitbuf >>= n
    bits.bitsleft -= n
    return entry


def deflate_decompress(
    data: bytes, out_nbytes_avail: int, known_size: bool
) -> tuple[int, bytes | None, int, int]:
    """Decompress one raw-DEFLATE stream.

    Returns ``(result, out_bytes, actual_in_nbytes, actual_out_nbytes)``.
    ``known_size=True`` replicates the reference's actual_out==NULL mode: the
    output must fill ``out_nbytes_avail`` exactly or SHORT_OUTPUT is returned.
    """
    bits = _Bits(data)
    out = bytearray(out_nbytes_avail)
    out_pos = 0

    while True:
        if not bits.ensure(3):
            return (BAD_DATA, None, 0, 0)
        is_final = bits.pop(1)
        block_type = bits.pop(2)

        if block_type == BLOCKTYPE_UNCOMPRESSED:
            bits.align_to_byte()
            if bits.n - bits.pos < 4:
                return (BAD_DATA, None, 0, 0)
            length = int.from_bytes(data[bits.pos : bits.pos + 2], "little")
            nlen = int.from_bytes(data[bits.pos + 2 : bits.pos + 4], "little")
            bits.pos += 4
            if length != (~nlen & 0xFFFF):
                return (BAD_DATA, None, 0, 0)
            if length > out_nbytes_avail - out_pos:
                return (INSUFFICIENT_SPACE, None, 0, 0)
            if length > bits.n - bits.pos:
                return (BAD_DATA, None, 0, 0)
            out[out_pos : out_pos + length] = data[bits.pos : bits.pos + length]
            bits.pos += length
            out_pos += length
            if is_final:
                break
            continue

        if block_type == BLOCKTYPE_STATIC_HUFFMAN:
            litlen_table = _STATIC_LITLEN_TABLE
            offset_table = _STATIC_OFFSET_TABLE
        elif block_type == BLOCKTYPE_DYNAMIC_HUFFMAN:
            if not bits.ensure(14):
                return (BAD_DATA, None, 0, 0)
            num_litlen = 257 + bits.pop(5)
            num_offsets = 1 + bits.pop(5)
            num_explicit = 4 + bits.pop(4)

            precode_lens = np.zeros(19, dtype=np.int64)
            for i in range(num_explicit):
                if not bits.ensure(3):
                    return (BAD_DATA, None, 0, 0)
                precode_lens[int(PRECODE_LENS_PERMUTATION[i])] = bits.pop(3)
            precode_table = build_precode_table(precode_lens)
            if precode_table is None:
                return (BAD_DATA, None, 0, 0)

            total = num_litlen + num_offsets
            lens = np.zeros(NUM_LITLEN_SYMS + NUM_OFFSET_SYMS, dtype=np.int64)
            i = 0
            while i < total:
                if not bits.ensure(7 + 7):
                    return (BAD_DATA, None, 0, 0)
                entry = _decode_sym(bits, precode_table, PRECODE_TABLEBITS)
                presym = (entry >> 16) & 0x3FFF
                if presym < 16:
                    lens[i] = presym
                    i += 1
                elif presym == 16:
                    if i == 0:
                        return (BAD_DATA, None, 0, 0)
                    rep = 3 + bits.pop(2)
                    if i + rep > total:
                        return (BAD_DATA, None, 0, 0)
                    lens[i : i + rep] = lens[i - 1]
                    i += rep
                elif presym == 17:
                    rep = 3 + bits.pop(3)
                    if i + rep > total:
                        return (BAD_DATA, None, 0, 0)
                    i += rep  # lens[] is already zero
                else:
                    rep = 11 + bits.pop(7)
                    if i + rep > total:
                        return (BAD_DATA, None, 0, 0)
                    i += rep
            litlen_table = build_litlen_table(lens[:num_litlen])
            if litlen_table is None:
                return (BAD_DATA, None, 0, 0)
            offset_table = build_offset_table(
                lens[num_litlen : num_litlen + num_offsets]
            )
            if offset_table is None:
                return (BAD_DATA, None, 0, 0)
        else:
            return (BAD_DATA, None, 0, 0)

        # --- Huffman block symbol loop ---
        while True:
            # Worst case per item: 15 (litlen) + 5 (extra) + 15 (offset) + 13
            if not bits.ensure(48):
                return (BAD_DATA, None, 0, 0)
            entry = _decode_sym(bits, litlen_table, LITLEN_TABLEBITS)
            kind = entry >> 30
            payload = (entry >> 16) & 0x3FFF
            if kind == KIND_LITERAL:
                if out_pos >= out_nbytes_avail:
                    return (INSUFFICIENT_SPACE, None, 0, 0)
                out[out_pos] = payload
                out_pos += 1
                continue
            if kind == KIND_EOB:
                if payload != 0:
                    return (BAD_DATA, None, 0, 0)  # symbol 286/287
                break
            # Match: payload is the length base.
            extra = (entry >> 8) & 0xFF
            length = payload + (bits.pop(extra) if extra else 0)

            oentry = _decode_sym(bits, offset_table, OFFSET_TABLEBITS)
            if oentry >> 30 != KIND_MATCH:
                return (BAD_DATA, None, 0, 0)  # offset symbol 30/31
            oslot = (oentry >> 16) & 0x3FFF
            oextra = (oentry >> 8) & 0xFF
            if bits.bitsleft < oextra and not bits.refill():
                return (BAD_DATA, None, 0, 0)
            offset = _OFFSET_BASES[oslot] + (bits.pop(oextra) if oextra else 0)

            if offset > out_pos:
                return (BAD_DATA, None, 0, 0)
            if length > out_nbytes_avail - out_pos:
                return (INSUFFICIENT_SPACE, None, 0, 0)
            src = out_pos - offset
            if offset >= length:
                out[out_pos : out_pos + length] = out[src : src + length]
                out_pos += length
            else:
                # Overlapping copy: replicate period by doubling.
                remaining = length
                avail = offset
                while remaining > 0:
                    n = min(avail, remaining)
                    out[out_pos : out_pos + n] = out[src : src + n]
                    out_pos += n
                    remaining -= n
                    avail += n
        if is_final:
            break

    if not bits.all_consumed_bits_real():
        return (BAD_DATA, None, 0, 0)
    if known_size and out_pos != out_nbytes_avail:
        return (SHORT_OUTPUT, None, 0, 0)
    return (SUCCESS, bytes(out[:out_pos]), bits.consumed_bytes(), out_pos)
