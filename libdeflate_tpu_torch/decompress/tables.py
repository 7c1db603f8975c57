"""Constants, entry format and table builder of the scalar DEFLATE decoder.

Counterpart of ``libdeflate_tpu/decompress/pallas_decode.py``: the RFC 1951
constants and the packed constant table ``_CONSTS`` (lines 67-129), the
table sizes and staging width (84-106), the entry format (module docstring
40-51, ``_make_entry`` 156-181) and ``_build_table_scalar`` (184-360), here
in plain Python.  ``csrc/decode_chunks.cu`` builds its tables in shared
memory with the same steps, reading ``CONSTS`` from the wrapper.

Entry format (32-bit, held here as a non-negative int below 2**32):
  bits 0..7   total consume bits (codeword + extra)
  bits 8..11  codeword length (to locate the extra field)
  bits 12..13 kind: 0 literal, 1 base payload (length/offset), 2 EOB/bad,
              3 subtable pointer (payload = subtable start, len = width)
  bit 14      two-literal flag (kind 0 only): second byte in bits 24..31
  bits 16..   payload (literal byte / base value / subtable start)
A kind-2 entry with payload 1 marks an invalid codeword.
"""

from __future__ import annotations

import numpy as np

LEN_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258], np.int32)
LEN_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0], np.int32)
OFF_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577], np.int32)
OFF_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13], np.int32)
PRECODE_PERM = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    np.int32)

LTB = 11                       # litlen main-table bits
OTB = 8                        # offset main-table bits
PTB = 7                        # precode table bits
LL_SIZE = (1 << LTB) + 294     # main + worst-case subtables
OF_SIZE = (1 << OTB) + 146
PRE_SIZE = 1 << PTB
STAGE_W = 2048                 # the reference's staged input words (8 KiB)
FLUSHB = 32768                 # the reference's flush period in bytes

K_LIT, K_BASE, K_EOB, K_SUB = 0, 1, 2, 3

# status codes (the JAX package's api.py result codes)
OK, BAD_DATA = 0, 1


def _static_lens() -> np.ndarray:
    lens = np.zeros(288 + 32, np.int32)
    sym = np.arange(288)
    lens[:288] = np.where(sym < 144, 8, np.where(sym < 256, 9,
                          np.where(sym < 280, 7, 8)))
    lens[288:] = 5
    return lens


STATIC_LENS = _static_lens()

# [0:29) LEN_BASE  [29:58) LEN_EXTRA  [58:88) OFF_BASE  [88:118) OFF_EXTRA
# [118:137) PRECODE_PERM  [137:457) static litlen+offset lens
CONSTS = np.concatenate(
    [LEN_BASE, LEN_EXTRA, OFF_BASE, OFF_EXTRA, PRECODE_PERM, STATIC_LENS]
).astype(np.int32)
C_LB, C_LE, C_OB, C_OE, C_PP, C_SL = 0, 29, 58, 88, 118, 137

# (table bits, size, `enough` bound) per role: 0 precode, 1 litlen, 2 offset
ROLE_TABLE = {0: (PTB, PRE_SIZE, PRE_SIZE), 1: (LTB, LL_SIZE, LL_SIZE),
              2: (OTB, OF_SIZE, OF_SIZE)}

_LB, _LE = LEN_BASE.tolist(), LEN_EXTRA.tolist()
_OB, _OE = OFF_BASE.tolist(), OFF_EXTRA.tolist()


def make_entry(role: int, sym: int, length: int) -> int:
    """Packed entry of a resolved codeword (``_make_entry``)."""
    if role == 0:
        return (sym << 16) | (length << 8) | length
    bad = (1 << 16) | (K_EOB << 12) | (length << 8) | length
    if role == 1:
        if sym < 256:
            return (sym << 16) | (K_LIT << 12) | (length << 8) | length
        if sym == 256:
            return (K_EOB << 12) | (length << 8) | length
        if sym > 285:
            return bad
        ls = sym - 257
        return ((_LB[ls] << 16) | (K_BASE << 12) | (length << 8)
                | (length + _LE[ls]))
    if sym >= 30:
        return bad
    return ((_OB[sym] << 16) | (K_BASE << 12) | (length << 8)
            | (length + _OE[sym]))


def _rev_bits(code: int, nbits: int) -> int:
    """Bit-reverse the low ``nbits`` of code (the reference reverses the
    low 15 bits, then shifts right by 15 - nbits)."""
    out = 0
    for _ in range(15):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out >> (15 - nbits)


def build_table(lens, role: int) -> tuple[list[int], bool]:
    """Decode table of one code (``_build_table_scalar``) from its codeword
    lengths: returns (table, ok), the table a list of entries of the
    role's size, unfilled slots 0.

    Steps of the reference, all kept: the Kraft count; the zlib-lax empty
    and single-length-1-codeword codes, whose table is filled with one
    entry (symbol 0 at length 1 for the empty code); the canonical walk,
    codewords longer than the main table going to a stash; one subtable per
    shared main-table prefix, failing once the next would pass ``enough``;
    for litlen, the two-literal pairing pass in descending index order; an
    oversubscribed code fails (its table is filled as the incomplete
    branch fills it).
    """
    table_bits, size, enough = ROLE_TABLE[role]
    lens = [int(x) for x in lens]
    nsyms = len(lens)
    table = [0] * size
    count = [0] * 17
    for ln in lens:
        if ln > 0:
            count[ln] += 1
    space = sum(count[ln] << (15 - ln) for ln in range(1, 16))

    if space != 1 << 15:
        # incomplete (or oversubscribed) code: the zlib-lax cases
        bad = space != 0 and (space != 1 << 14 or count[1] != 1)
        sym = next((i for i in range(nsyms) if lens[i] == 1), -1)
        sym = 0 if space == 0 else max(sym, 0)
        table[:1 << table_bits] = [make_entry(role, sym, 1)] * (
            1 << table_bits)
        return table, not bad

    # counting sort into canonical order
    offs = [0] * 17
    acc = 0
    for ln in range(1, 16):
        offs[ln] = acc
        acc += count[ln]
    order = [0] * acc
    for i, ln in enumerate(lens):
        if ln > 0:
            order[offs[ln]] = i
            offs[ln] += 1

    # canonical codeword walk; codewords longer than table_bits are stashed
    stash = []                                       # (rc, len, sym)
    code, prev_len = 0, 1
    for sym in order:
        ln = lens[sym]
        code <<= ln - prev_len
        rc = _rev_bits(code, ln)
        if ln <= table_bits:
            e = make_entry(role, sym, ln)
            for idx in range(rc, 1 << table_bits, 1 << ln):
                table[idx] = e
        else:
            stash.append((rc, ln, sym))
        code += 1
        prev_len = ln

    # subtables: one run per shared low-table_bits prefix
    mask = (1 << table_bits) - 1
    i, cur_sub, ok = 0, 1 << table_bits, True
    while i < len(stash) and ok:
        prefix = stash[i][0] & mask
        j = i
        while j < len(stash) and (stash[j][0] & mask) == prefix:
            j += 1
        sub_bits = stash[j - 1][1] - table_bits
        sub_start = cur_sub
        cur_sub += 1 << sub_bits
        if cur_sub > enough:
            ok = False
            break
        table[prefix] = (sub_start << 16) | (K_SUB << 12) | (sub_bits << 8)
        for rc, ln, sym in stash[i:j]:
            e = make_entry(role, sym, ln)
            step = 1 << (ln - table_bits)
            for idx in range(rc >> table_bits, 1 << sub_bits, step):
                table[sub_start + idx] = e
        i = j

    if role == 1:
        # two-literal pairing: descending index order, so the second
        # lookup (idx >> l1 < idx) reads an entry not yet paired
        for idx in range((1 << table_bits) - 1, -1, -1):
            e1 = table[idx]
            l1 = e1 & 0xFF
            if ((e1 >> 12) & 3) != K_LIT or not 1 <= l1 < table_bits \
                    or e1 & 0x4000:
                continue
            e2 = table[idx >> l1]
            l2 = e2 & 0xFF
            if ((e2 >> 12) & 3) == K_LIT and not e2 & 0x4000 \
                    and l1 + l2 <= table_bits:
                table[idx] = (((e2 >> 16) << 24) | ((e1 >> 16) << 16)
                              | (1 << 14) | (K_LIT << 12) | (l1 + l2))
    return table, ok
