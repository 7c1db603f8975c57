"""DEFLATE block emission: cost modeling, header construction, bit packing.

Role parity with the reference's ``deflate_flush_block``
(``lib/deflate_compress.c:1706-2038``): given a parsed item sequence, compute
the exact cost of dynamic vs static vs stored encodings (including the
precode), pick the cheapest (ties prefer stored, then static, then dynamic),
and emit the block.

TPU-first design note: emission is formulated over *arrays of items*
(symbol/extra columns), not a per-symbol bitbuffer state machine.  The bit
packing uses the two-pass plan from SURVEY.md §7: per-item bit lengths →
exclusive prefix sum of bit offsets → scatter-OR of shifted codewords into a
word array.  The same plan is what the device pipeline uses, so host and TPU
emit paths share this module's table preparation.

The port's own copy of ``libdeflate_tpu/compress/emit.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import (
    END_OF_BLOCK,
    LENGTH_SLOT_EXTRA,
    LENGTH_SLOT_BASE,
    LENGTH_TO_SLOT,
    MAX_PRE_CODEWORD_LEN,
    NUM_LITLEN_SYMS,
    NUM_OFFSET_SYMS,
    NUM_PRECODE_SYMS,
    OFFSET_SLOT_BASE,
    OFFSET_SLOT_EXTRA,
    PRECODE_LENS_PERMUTATION,
    PRECODE_SYM_COPY_PREV,
    PRECODE_SYM_REPEAT_ZERO_3,
    PRECODE_SYM_REPEAT_ZERO_11,
    STATIC_LITLEN_CODES,
    STATIC_LITLEN_LENS,
    STATIC_OFFSET_CODES,
    STATIC_OFFSET_LENS,
    COMPRESSOR_MAX_LITLEN_CODEWORD_LEN,
    offset_to_slot,
)
from ..huffman.build import make_huffman_code


class BitWriter:
    """LSB-first bit accumulator producing a byte stream."""

    __slots__ = ("bitbuf", "bitcount", "out")

    def __init__(self):
        self.bitbuf = 0
        self.bitcount = 0
        self.out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        self.bitbuf |= value << self.bitcount
        self.bitcount += nbits
        if self.bitcount >= 64:
            self.out += (self.bitbuf & (2**64 - 1)).to_bytes(8, "little")
            self.bitbuf >>= 64
            self.bitcount -= 64

    def add_words(self, words: np.ndarray, nbits: int) -> None:
        """Append ``nbits`` packed LSB-first bits held in a uint32 array."""
        if self.bitcount >= 8:
            # drain whole pending bytes first so the merge shift stays < 8
            while self.bitcount >= 8:
                self.out.append(self.bitbuf & 0xFF)
                self.bitbuf >>= 8
                self.bitcount -= 8
        if self.bitcount:
            # vector shift-merge to byte alignment: prepend the pending bits
            # and shift the whole array once (blocks almost always start
            # unaligned — the 3-bit block header — so this IS the hot path)
            bc = self.bitcount
            w64 = words.astype(np.uint64)
            lo = (w64 << np.uint64(bc)) & np.uint64(0xFFFFFFFF)
            hi = w64 >> np.uint64(32 - bc)
            merged = np.empty(words.shape[0] + 1, dtype=np.uint64)
            merged[0] = self.bitbuf & ((1 << bc) - 1)
            merged[1:] = hi
            merged[: words.shape[0]] |= lo
            words = merged.astype(np.uint32)
            nbits += bc
            self.bitbuf = 0
            self.bitcount = 0
        full_bytes = nbits // 8
        raw = words.tobytes()[:full_bytes]
        self.out += raw
        rem = nbits - 8 * full_bytes
        if rem:
            self.bitbuf = words.tobytes()[full_bytes] & ((1 << rem) - 1)
            self.bitcount = rem

    def align_to_byte(self) -> None:
        pad = (-self.bitcount) % 8
        if pad:
            self.add(0, pad)
        while self.bitcount >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcount -= 8

    def finish(self) -> bytes:
        self.align_to_byte()
        assert self.bitcount == 0
        return bytes(self.out)

    def bit_length(self) -> int:
        return 8 * len(self.out) + self.bitcount


def pack_bits_vectorized(values: np.ndarray, nbits: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack (value, nbits) items LSB-first into a uint32 word array.

    Two-pass plan: exclusive prefix sum of nbits gives each item's bit offset;
    each value (< 2**32) is shifted and scatter-OR'd into up to two words.
    Returns (words, total_bits).
    """
    nbits = nbits.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(nbits)])
    total = int(offs[-1])
    # +2: a zero-width item can start exactly at `total` on a 32-bit
    # boundary, and its (empty) hi half still scatters into word_idx + 1
    nwords = (total + 31) // 32 + 2
    words = np.zeros(nwords, dtype=np.uint64)
    word_idx = (offs[:-1] >> 5).astype(np.int64)
    shift = (offs[:-1] & 31).astype(np.uint64)
    # Mask each value to its declared width (items with nbits=0 contribute
    # nothing even if their value column holds garbage).
    mask = (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)
    v = (values.astype(np.uint64) & mask) << shift
    lo = v & np.uint64(0xFFFFFFFF)
    hi = v >> np.uint64(32)
    np.bitwise_or.at(words, word_idx, lo)
    np.bitwise_or.at(words, word_idx + 1, hi)
    return words.astype(np.uint32), total


# --- Item sequences -------------------------------------------------------
# A parsed block is three parallel arrays:
#   kinds : uint8, 0 = literal, 1 = match
#   vals  : int32, literal byte (kind 0) or match length (kind 1)
#   offs  : int32, match offset (kind 1 only)


def item_symbols(kinds, vals, offs):
    """Map items to (litlen_sym, len_extra_val/bits, off_sym, off_extra_val/bits)."""
    is_match = kinds == 1
    length = np.where(is_match, vals, 0)
    lit = np.where(is_match, 0, vals)
    lslot = LENGTH_TO_SLOT[length]
    litlen_sym = np.where(is_match, 257 + lslot, lit)
    len_extra_bits = np.where(is_match, LENGTH_SLOT_EXTRA[lslot], 0)
    len_extra_val = np.where(is_match, length - LENGTH_SLOT_BASE[lslot], 0)
    oslot = np.where(is_match, offset_to_slot(np.maximum(offs, 1)), 0)
    off_extra_bits = np.where(is_match, OFFSET_SLOT_EXTRA[oslot], 0)
    off_extra_val = np.where(is_match, offs - OFFSET_SLOT_BASE[oslot], 0)
    return litlen_sym, len_extra_val, len_extra_bits, oslot, off_extra_val, off_extra_bits


def block_histograms(kinds, vals, offs):
    sym, _, _, oslot, _, _ = item_symbols(kinds, vals, offs)
    litlen_freq = np.bincount(sym, minlength=NUM_LITLEN_SYMS).astype(np.int64)
    litlen_freq[END_OF_BLOCK] += 1
    off_freq = np.bincount(
        oslot[kinds == 1], minlength=NUM_OFFSET_SYMS
    ).astype(np.int64)
    return litlen_freq, off_freq


def rle_encode_lens(lens: np.ndarray) -> tuple[list[int], list[int], list[int]]:
    """RLE-encode codeword lengths with precode symbols 16/17/18.

    Returns (precode_syms, extra_vals, extra_bits) per emitted precode item.
    Mirrors the run semantics of deflate_compute_precode_items
    (lib/deflate_compress.c:1482-1557).
    """
    syms: list[int] = []
    xv: list[int] = []
    xb: list[int] = []
    n = len(lens)
    i = 0
    while i < n:
        val = int(lens[i])
        run = 1
        while i + run < n and int(lens[i + run]) == val:
            run += 1
        if val == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                syms.append(PRECODE_SYM_REPEAT_ZERO_11)
                xv.append(take - 11)
                xb.append(7)
                r -= take
            if r >= 3:
                syms.append(PRECODE_SYM_REPEAT_ZERO_3)
                xv.append(r - 3)
                xb.append(3)
                r = 0
            for _ in range(r):
                syms.append(0)
                xv.append(0)
                xb.append(0)
        else:
            syms.append(val)
            xv.append(0)
            xb.append(0)
            r = run - 1
            while r >= 3:
                take = min(r, 6)
                syms.append(PRECODE_SYM_COPY_PREV)
                xv.append(take - 3)
                xb.append(2)
                r -= take
            for _ in range(r):
                syms.append(val)
                xv.append(0)
                xb.append(0)
        i += run
    return syms, xv, xb


class BlockCodes:
    """Huffman codes + header plan for one dynamic block."""

    def __init__(self, litlen_freq: np.ndarray, off_freq: np.ndarray):
        self.litlen_lens, self.litlen_codes = make_huffman_code(
            litlen_freq, COMPRESSOR_MAX_LITLEN_CODEWORD_LEN
        )
        self.off_lens, self.off_codes = make_huffman_code(off_freq, 15)

        used_lit = np.flatnonzero(self.litlen_lens)
        used_off = np.flatnonzero(self.off_lens)
        self.num_litlen = max(257, int(used_lit[-1]) + 1) if used_lit.size else 257
        self.num_offsets = max(1, int(used_off[-1]) + 1) if used_off.size else 1

        all_lens = np.concatenate(
            [self.litlen_lens[: self.num_litlen], self.off_lens[: self.num_offsets]]
        )
        self.pre_syms, self.pre_xv, self.pre_xb = rle_encode_lens(all_lens)
        pre_freq = np.bincount(self.pre_syms, minlength=NUM_PRECODE_SYMS)
        self.pre_lens, self.pre_codes = make_huffman_code(
            pre_freq, MAX_PRE_CODEWORD_LEN
        )
        # Trim trailing zero-length precode entries in permuted order (>= 4).
        perm_lens = self.pre_lens[PRECODE_LENS_PERMUTATION]
        nz = np.flatnonzero(perm_lens)
        self.num_explicit_pre = max(4, (int(nz[-1]) + 1) if nz.size else 0)

    def header_cost_bits(self) -> int:
        cost = 5 + 5 + 4 + 3 * self.num_explicit_pre
        for s, b in zip(self.pre_syms, self.pre_xb):
            cost += int(self.pre_lens[s]) + b
        return cost

    def body_cost_bits(self, litlen_freq, off_freq, len_extra_total, off_extra_total) -> int:
        return (
            int((litlen_freq * self.litlen_lens).sum())
            + int((off_freq * self.off_lens).sum())
            + len_extra_total
            + off_extra_total
        )

    def emit_header(self, w: BitWriter) -> None:
        w.add(self.num_litlen - 257, 5)
        w.add(self.num_offsets - 1, 5)
        w.add(self.num_explicit_pre - 4, 4)
        for i in range(self.num_explicit_pre):
            w.add(int(self.pre_lens[int(PRECODE_LENS_PERMUTATION[i])]), 3)
        for s, v, b in zip(self.pre_syms, self.pre_xv, self.pre_xb):
            w.add(int(self.pre_codes[s]), int(self.pre_lens[s]))
            if b:
                w.add(v, b)


def static_cost_bits(litlen_freq, off_freq, len_extra_total, off_extra_total) -> int:
    return (
        int((litlen_freq * STATIC_LITLEN_LENS).sum())
        + int((off_freq * STATIC_OFFSET_LENS).sum())
        + len_extra_total
        + off_extra_total
    )


def stored_cost_bits(block_nbytes: int, cur_bitcount: int) -> int:
    """Exact cost of storing block_nbytes raw, incl. alignment + 5B headers.

    Stored blocks are chains of <= 65535-byte segments
    (cf. deflate_flush_block's stored path).
    """
    nseg = max((block_nbytes + 65534) // 65535, 1)
    align = (-(cur_bitcount + 3)) % 8
    # First segment: 3 header bits + alignment + LEN/NLEN.  Each further
    # segment starts byte-aligned: 3 + 5 pad + 32.
    return 3 + align + 32 + 40 * (nseg - 1) + 8 * block_nbytes


def emit_stored(w: BitWriter, data: bytes, is_final: bool) -> None:
    n = len(data)
    pos = 0
    first = True
    while first or pos < n:
        first = False
        seg = min(n - pos, 65535)
        final_seg = is_final and (pos + seg == n)
        w.add(1 if final_seg else 0, 1)
        w.add(0, 2)  # BTYPE=00
        w.align_to_byte()
        w.out += seg.to_bytes(2, "little")
        w.out += (~seg & 0xFFFF).to_bytes(2, "little")
        w.out += data[pos : pos + seg]
        pos += seg


def emit_items(
    w: BitWriter,
    kinds,
    vals,
    offs,
    litlen_lens,
    litlen_codes,
    off_lens,
    off_codes,
) -> None:
    """Vectorized item emission: build (value, nbits) columns and bit-pack."""
    sym, lxv, lxb, oslot, oxv, oxb = item_symbols(kinds, vals, offs)
    # Column 1: litlen codeword + length extra bits, fused (<= 14+5 bits).
    c1 = litlen_codes[sym].astype(np.uint64) | (
        lxv.astype(np.uint64) << litlen_lens[sym].astype(np.uint64)
    )
    n1 = litlen_lens[sym] + lxb
    # Column 2: offset codeword + offset extra bits (<= 15+13 bits).
    c2 = off_codes[oslot].astype(np.uint64) | (
        oxv.astype(np.uint64) << off_lens[oslot].astype(np.uint64)
    )
    n2 = np.where(kinds == 1, off_lens[oslot] + oxb, 0)
    values = np.empty(2 * len(sym), dtype=np.uint64)
    nbits = np.empty(2 * len(sym), dtype=np.int64)
    values[0::2] = c1
    values[1::2] = c2
    nbits[0::2] = n1
    nbits[1::2] = n2
    words, total = pack_bits_vectorized(values, nbits)
    w.add_words(words, total)


def flush_block(
    w: BitWriter,
    data_block: bytes,
    kinds: np.ndarray,
    vals: np.ndarray,
    offs: np.ndarray,
    is_final: bool,
) -> None:
    """Choose stored/static/dynamic and emit (parity: deflate_flush_block)."""
    litlen_freq, off_freq = block_histograms(kinds, vals, offs)
    sym, _, lxb, oslot, _, oxb = item_symbols(kinds, vals, offs)
    len_extra_total = int(lxb.sum())
    off_extra_total = int(oxb.sum())

    codes = BlockCodes(litlen_freq, off_freq)
    dyn_cost = 3 + codes.header_cost_bits() + codes.body_cost_bits(
        litlen_freq, off_freq, len_extra_total, off_extra_total
    )
    st_cost = 3 + static_cost_bits(
        litlen_freq, off_freq, len_extra_total, off_extra_total
    )
    sd_cost = stored_cost_bits(len(data_block), w.bit_length())

    # Tie-break preference: stored, then static, then dynamic (reference
    # ordering at lib/deflate_compress.c:1779-1814).
    if sd_cost <= st_cost and sd_cost <= dyn_cost:
        emit_stored(w, data_block, is_final)
        return
    if st_cost <= dyn_cost:
        w.add(1 if is_final else 0, 1)
        w.add(1, 2)  # BTYPE=01
        litlen_lens, litlen_codes = STATIC_LITLEN_LENS, STATIC_LITLEN_CODES
        off_lens, off_codes = STATIC_OFFSET_LENS, STATIC_OFFSET_CODES
    else:
        w.add(1 if is_final else 0, 1)
        w.add(2, 2)  # BTYPE=10
        codes.emit_header(w)
        litlen_lens, litlen_codes = codes.litlen_lens, codes.litlen_codes
        off_lens, off_codes = codes.off_lens, codes.off_codes

    emit_items(w, kinds, vals, offs, litlen_lens, litlen_codes, off_lens, off_codes)
    w.add(int(litlen_codes[END_OF_BLOCK]), int(litlen_lens[END_OF_BLOCK]))
