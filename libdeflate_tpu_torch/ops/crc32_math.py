"""CRC-32 (gzip polynomial) GF(2) math: tables, advance matrices, combine.

The port's own copy of ``libdeflate_tpu/ops/crc32_math.py``, in numpy only,
holding what ``ops/checksums.py`` needs.  The CRC register update is linear
over GF(2), so "advance the register by k zero bytes" is a 32x32 bit matrix
``A^k``; ``A^(2^j)`` is precomputed by squaring, which gives O(log n)
``crc32_combine`` and the per-level matrices of the checksum's combine tree.
``crc32_combine_by_table`` applies ``A^k`` as four 256-entry tables of
ints, built once a length: the whole-file trailer combines every chunk at
one length.

All matrices are stored column-major as uint32 vectors: ``M @ v`` = XOR of
``cols[j]`` over the set bits ``j`` of ``v``.
"""

from __future__ import annotations

import functools

import numpy as np

# Reflected gzip CRC-32 polynomial.
POLY_REFLECTED = 0xEDB88320


def _make_byte_table() -> np.ndarray:
    """The 256-entry table: T[b] = register after byte b from state 0."""
    t = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (POLY_REFLECTED if (c & 1) else 0)
        t[b] = c
    return t.astype(np.uint32)


CRC_BYTE_TABLE = _make_byte_table()

# Per-bit decomposition of the byte table: T[b] = XOR of BIT_TABLE[j] for
# each set bit j of b (linearity).
CRC_BIT_TABLE = CRC_BYTE_TABLE[np.left_shift(1, np.arange(8))]


def mat_vec(cols: np.ndarray, v):
    """Apply a GF(2) 32x32 matrix (32 uint32 columns) to vector(s) v."""
    v = np.asarray(v, dtype=np.uint32)
    out = np.zeros_like(v)
    for j in range(32):
        bit = (v >> np.uint32(j)) & np.uint32(1)
        out ^= cols[j] * bit
    return out


def _advance_one_byte_matrix() -> np.ndarray:
    """Matrix of the one-zero-byte update c -> (c >> 8) ^ T[c & 0xff]."""
    basis = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    return (basis >> np.uint32(8)) ^ CRC_BYTE_TABLE[basis & np.uint32(0xFF)]


def _make_advance_pow2(max_log: int = 40) -> np.ndarray:
    """ADVANCE_POW2[j] advances the register past 2^j zero bytes."""
    mats = np.zeros((max_log, 32), dtype=np.uint32)
    mats[0] = _advance_one_byte_matrix()
    for j in range(1, max_log):
        mats[j] = mat_vec(mats[j - 1], mats[j - 1])
    return mats


ADVANCE_POW2 = _make_advance_pow2()


def _gf2_inverse(cols: np.ndarray) -> np.ndarray:
    """Invert a GF(2) 32x32 matrix given as 32 uint32 columns, by
    Gauss-Jordan over the rows of [M | I].  The one-zero-byte advance is
    invertible (its polynomial has a nonzero constant term), so all its
    powers are."""
    rows = [sum(((int(cols[j]) >> i) & 1) << j for j in range(32))
            | (1 << (32 + i)) for i in range(32)]
    for col in range(32):
        piv = next(i for i in range(col, 32) if (rows[i] >> col) & 1)
        rows[col], rows[piv] = rows[piv], rows[col]
        for i in range(32):
            if i != col and (rows[i] >> col) & 1:
                rows[i] ^= rows[col]
    inv = [r >> 32 for r in rows]
    return np.array([sum(((inv[i] >> j) & 1) << i for i in range(32))
                     for j in range(32)], np.uint32)


# INV_ADVANCE_POW2[j] rewinds the register past 2^j zero bytes: the checksum
# undoes its end padding with it.
INV_ADVANCE_POW2 = np.stack([_gf2_inverse(m) for m in ADVANCE_POW2])


def advance(crc_reg, nbytes: int):
    """Advance raw CRC register(s) past ``nbytes`` zero bytes."""
    v = np.asarray(crc_reg, dtype=np.uint32)
    j = 0
    while nbytes:
        if nbytes & 1:
            v = mat_vec(ADVANCE_POW2[j], v)
        nbytes >>= 1
        j += 1
    return v


# Block matrix: BLOCK_BITS_MATRIX[p*8 + k] is the raw-register contribution
# of bit k of the byte at position p within a CRC_BLOCK-byte block, so the
# whole intra-block reduction is ONE GF(2) matrix-vector product, done as an
# exact float32 matrix product followed by mod 2.
CRC_BLOCK = 2048


def _make_block_bits_matrix(k_bytes: int = CRC_BLOCK) -> np.ndarray:
    rows = np.zeros((k_bytes, 8), dtype=np.uint32)
    vals = CRC_BIT_TABLE.copy()  # contributions at the LAST byte position
    adv1 = ADVANCE_POW2[0]
    for p in range(k_bytes - 1, -1, -1):
        rows[p] = vals
        vals = mat_vec(adv1, vals)
    return rows.reshape(k_bytes * 8)


BLOCK_BITS_MATRIX = _make_block_bits_matrix()


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of A||B from crc32(A), crc32(B), |B| (zlib-compatible)."""
    return int(advance(np.uint32(crc1), len2)) ^ crc2


@functools.lru_cache(maxsize=64)
def _advance_tables(nbytes: int) -> tuple[list[int], ...]:
    """``advance`` past ``nbytes`` zero bytes as four 256-entry tables, one
    a byte of the register: entry b of table k is the XOR of the operator's
    columns 8k + j over the set bits j of b."""
    basis = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    cols = advance(basis, nbytes).tolist()
    tables = []
    for k in range(4):
        t = [0] * 256
        for b in range(1, 256):
            low = b & -b
            t[b] = t[b ^ low] ^ cols[8 * k + low.bit_length() - 1]
        tables.append(t)
    return tuple(tables)


def crc32_combine_by_table(crc1: int, crc2: int, len2: int) -> int:
    """``crc32_combine`` by the cached tables of ``len2``: four lookups and
    XORs a call once a length's tables are built."""
    t0, t1, t2, t3 = _advance_tables(len2)
    return (t0[crc1 & 0xFF] ^ t1[crc1 >> 8 & 0xFF] ^ t2[crc1 >> 16 & 0xFF]
            ^ t3[crc1 >> 24 & 0xFF] ^ crc2)
