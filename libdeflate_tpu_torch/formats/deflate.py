"""DEFLATE (RFC 1951) format constants and derived tables.

This module is the TPU-native analogue of the reference's format-constant layer
(``lib/deflate_constants.h``, the slot tables at ``lib/deflate_compress.c:237-308``,
and the generator scripts ``scripts/gen_offset_slot_map.py`` /
``scripts/gen_bitreverse_tab.py``).  Everything here is *derived* at import time
from the RFC definitions rather than hard-coded, and exposed as NumPy arrays so
the same tables can be fed directly to JAX/Pallas kernels as device constants.

No code is executed on-device here; this is the pure table layer (SURVEY.md §7
step 1).

The port's own copy of ``libdeflate_tpu/formats/deflate.py``, whole.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Block types (RFC 1951 §3.2.3; cf. lib/deflate_constants.h)
# ---------------------------------------------------------------------------
BLOCKTYPE_UNCOMPRESSED = 0
BLOCKTYPE_STATIC_HUFFMAN = 1
BLOCKTYPE_DYNAMIC_HUFFMAN = 2

# Match/window geometry
MIN_MATCH_LEN = 3
MAX_MATCH_LEN = 258
MAX_MATCH_OFFSET = 32768
WINDOW_SIZE = 32768

# Symbol alphabet sizes
NUM_PRECODE_SYMS = 19
NUM_LITLEN_SYMS = 288
NUM_OFFSET_SYMS = 32
MAX_NUM_SYMS = 288

# End-of-block symbol
END_OF_BLOCK = 256

# Precode (code-length code) symbol semantics
MIN_CODEWORD_LEN = 1
MAX_CODEWORD_LEN = 15
MAX_PRE_CODEWORD_LEN = 7
MAX_LITLEN_CODEWORD_LEN = 15
MAX_OFFSET_CODEWORD_LEN = 15

# The compressor limits litlen codeword lengths to 14 bits so that four
# buffered literals always fit in the bit buffer (reference rationale at
# lib/deflate_compress.c:109-117).  Decoders must still accept 15.
COMPRESSOR_MAX_LITLEN_CODEWORD_LEN = 14

# Maximum overrun of the lens[] array when decoding the precode RLE
# (reference: DEFLATE_MAX_LENS_OVERRUN, lib/deflate_constants.h).
MAX_LENS_OVERRUN = 137

# The order in which precode codeword lengths are stored in the block header
# (RFC 1951 §3.2.7).
PRECODE_LENS_PERMUTATION = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Precode symbols 16/17/18: repeat semantics (RFC 1951 §3.2.7)
PRECODE_SYM_COPY_PREV = 16          # repeat previous length 3..6   (2 extra bits)
PRECODE_SYM_REPEAT_ZERO_3 = 17      # repeat zero 3..10             (3 extra bits)
PRECODE_SYM_REPEAT_ZERO_11 = 18     # repeat zero 11..138           (7 extra bits)


def _build_length_slots() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Length codes 257..285: (base, extra_bits) per slot and a len->slot map.

    RFC 1951 §3.2.5.  Slot s corresponds to litlen symbol 257+s.  Length 258
    always maps to the final slot (symbol 285, zero extra bits), as in the
    reference's length-slot table (lib/deflate_compress.c:269-285).
    """
    base = []
    extra = []
    length = 3
    # Slots 0..27 follow the doubling pattern; slot 28 is the special len-258.
    extra_pattern = (
        [0, 0, 0, 0, 0, 0, 0, 0]
        + [1, 1, 1, 1]
        + [2, 2, 2, 2]
        + [3, 3, 3, 3]
        + [4, 4, 4, 4]
        + [5, 5, 5, 5]
    )
    for eb in extra_pattern:
        base.append(length)
        extra.append(eb)
        length += 1 << eb
    # Slot 28: length 258 exactly, 0 extra bits.
    base.append(258)
    extra.append(0)
    base_a = np.array(base, dtype=np.int32)
    extra_a = np.array(extra, dtype=np.int32)

    # len -> slot map for len in [0, 258] (entries < 3 unused, set to 0)
    len_to_slot = np.zeros(MAX_MATCH_LEN + 1, dtype=np.int32)
    for s in range(len(base)):
        lo = base[s]
        hi = base[s + 1] if s + 1 < len(base) else 258
        len_to_slot[lo:hi] = s
    len_to_slot[258] = 28
    return base_a, extra_a, len_to_slot


def _build_offset_slots() -> tuple[np.ndarray, np.ndarray]:
    """Offset codes 0..29: (base, extra_bits).  RFC 1951 §3.2.5."""
    base = []
    extra = []
    off = 1
    extra_pattern = [0, 0, 0, 0] + [i // 2 for i in range(2, 28)]
    for eb in extra_pattern:
        base.append(off)
        extra.append(eb)
        off += 1 << eb
    return np.array(base, dtype=np.int32), np.array(extra, dtype=np.int32)


LENGTH_SLOT_BASE, LENGTH_SLOT_EXTRA, LENGTH_TO_SLOT = _build_length_slots()
OFFSET_SLOT_BASE, OFFSET_SLOT_EXTRA = _build_offset_slots()

assert LENGTH_SLOT_BASE.shape[0] == 29
assert OFFSET_SLOT_BASE.shape[0] == 30
assert int(OFFSET_SLOT_BASE[-1]) == 24577


def _build_offset_to_slot_small() -> np.ndarray:
    """offset -> slot for offsets 1..256 (direct map).

    For offsets > 256 use :func:`offset_to_slot`, which mirrors the
    reference's log-trick split (lib/deflate_compress.c:291-308) but as array
    arithmetic.
    """
    m = np.zeros(257, dtype=np.int32)
    for s in range(30):
        lo = int(OFFSET_SLOT_BASE[s])
        hi = int(OFFSET_SLOT_BASE[s + 1]) if s + 1 < 30 else 32769
        lo = max(lo, 1)
        if lo > 256:
            break
        m[lo : min(hi, 257)] = s
    return m


OFFSET_TO_SLOT_SMALL = _build_offset_to_slot_small()


def offset_to_slot(offset):
    """Vectorized offset(1..32768) -> offset slot(0..29).

    Works on NumPy or JAX integer arrays.  Uses the small direct table for
    offsets <= 256 and a log2-based formula above that (slots >= 16 come in
    pairs per power of two).
    """
    off = np.asarray(offset, dtype=np.int64)
    xp = np
    small = OFFSET_TO_SLOT_SMALL[xp.minimum(off, 256)]
    # For off in (256, 32768]: slot = 2*floor(log2(off-1)) - 2 + msb-adjust.
    # Each power-of-two band [2^k+1, 2^(k+1)] splits into two slots at
    # 2^k + 2^(k-1).  Derive from bit length of (off-1).
    o1 = off - 1
    # floor(log2(o1)) for o1 >= 256
    k = (xp.log2(o1.astype(np.float64) + (o1 <= 0))).astype(np.int32)
    half = (o1 >> (k - 1)) & 1  # second half of the band?
    big = 2 * k + half
    return xp.where(off <= 256, small, big)


# ---------------------------------------------------------------------------
# Static Huffman code (RFC 1951 §3.2.6; cf. deflate_init_static_codes,
# lib/deflate_compress.c:1432-1450)
# ---------------------------------------------------------------------------
STATIC_LITLEN_LENS = np.array(
    [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, dtype=np.int32
)
STATIC_OFFSET_LENS = np.full(32, 5, dtype=np.int32)


def reverse_bits(codes, nbits):
    """Bit-reverse each value in ``codes`` within ``nbits`` bits (vectorized).

    DEFLATE packs Huffman codewords MSB-first into an LSB-first bitstream, so
    canonical codewords must be bit-reversed before emission (cf. the
    reference's bitreverse table, scripts/gen_bitreverse_tab.py).
    """
    codes = np.asarray(codes, dtype=np.uint32)
    nbits = np.asarray(nbits, dtype=np.uint32)
    out = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(15):
        out = (out << np.uint32(1)) | (tmp & np.uint32(1))
        tmp >>= np.uint32(1)
    # 'out' now holds the 15-bit reversal; shift down to the requested width.
    return (out >> (np.uint32(15) - nbits)) & ((np.uint32(1) << nbits) - np.uint32(1))


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Assign canonical Huffman codewords (MSB-first values) from lengths.

    RFC 1951 §3.2.2 algorithm.  Returns an array of codeword *values* (not yet
    bit-reversed); symbols with len 0 get code 0.
    """
    lens = np.asarray(lens, dtype=np.int64)
    max_len = int(lens.max()) if lens.size else 0
    bl_count = np.bincount(lens, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for b in range(1, max_len + 1):
        code = (code + int(bl_count[b - 1])) << 1
        next_code[b] = code
    codes = np.zeros_like(lens)
    # Per-symbol sequential assignment (canonical order = symbol order within
    # each length).  288 symbols max, so a Python loop is fine here.
    nc = next_code.copy()
    for sym in range(lens.shape[0]):
        l = int(lens[sym])
        if l:
            codes[sym] = nc[l]
            nc[l] += 1
    return codes.astype(np.uint32)


# Precomputed static codewords, already bit-reversed (emit-ready, LSB-first).
STATIC_LITLEN_CODES = reverse_bits(
    canonical_codes(STATIC_LITLEN_LENS), STATIC_LITLEN_LENS.astype(np.uint32)
)
STATIC_OFFSET_CODES = reverse_bits(
    canonical_codes(STATIC_OFFSET_LENS), STATIC_OFFSET_LENS.astype(np.uint32)
)

# ---------------------------------------------------------------------------
# Compressed-size bound (contract parity with
# libdeflate_deflate_compress_bound, lib/deflate_compress.c:4087-4135)
# ---------------------------------------------------------------------------
MIN_BLOCK_LENGTH = 5000
SOFT_MAX_BLOCK_LENGTH = 300000
SEQ_STORE_LENGTH = 50000


def deflate_compress_bound(in_nbytes: int) -> int:
    """Worst-case DEFLATE output size: 5 bytes/block overhead + payload."""
    max_blocks = max((in_nbytes + MIN_BLOCK_LENGTH - 1) // MIN_BLOCK_LENGTH, 1)
    return 5 * max_blocks + in_nbytes
