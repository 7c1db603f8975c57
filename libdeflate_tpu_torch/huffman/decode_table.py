"""Table-driven Huffman decode tables (packed uint32 entries).

Role parity with the reference's ``build_decode_table``
(``lib/deflate_decompress.c:721-1004``): build a one-level-of-subtables decode
table from canonical codeword lengths, accepting the incomplete-code cases
the reference accepts — what zlib accepts "plus a bit more": an empty code or
a single length-1 codeword is mapped to a complete 1-bit code on the used
symbol (rules at ``lib/deflate_decompress.c:803-853``), so a stream that
actually USES an undefined codeword of an accepted-incomplete code decodes
like the reference rather than erroring like zlib.

The packed entry layout here is our own, chosen so the same uint32 arrays can
be consumed by the NumPy host decoder and by JAX/Pallas device decoders with
pure integer ops:

    bits [31:30] kind: 0=LITERAL  1=MATCH(length/offset)  2=EOB/invalid
                 3=SUBTABLE pointer
    bits [29:16] payload (14 bits):
                 LITERAL: byte value
                 MATCH (litlen table): length base (3..258)
                 MATCH (offset table): offset *slot* (0..29); base/extra come
                     from the OFFSET_SLOT_* tables
                 EOB: 0 = real end-of-block, 1 = invalid symbol (286/287,
                     offset 30/31)
                 SUBTABLE: absolute index of the subtable within this array
    bits [15:8]  extra bits to read after the codeword (MATCH), or subtable
                 index width in bits (SUBTABLE)
    bits [7:0]   bits consumed by the codeword itself.  For SUBTABLE entries
                 this is the main-table width; entries inside a subtable store
                 their full codeword length, so after a subtable hop the
                 decoder consumes the subtable entry's count directly.

Table sizing uses the same proven 'ENOUGH' bounds as the reference
(lib/deflate_decompress.c:370-375): precode 7/128, litlen 11/2342,
offset 8/402.

The port's own copy of ``libdeflate_tpu/huffman/decode_table.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import (
    LENGTH_SLOT_BASE,
    LENGTH_SLOT_EXTRA,
    NUM_LITLEN_SYMS,
    NUM_OFFSET_SYMS,
    NUM_PRECODE_SYMS,
    canonical_codes,
    reverse_bits,
)

KIND_LITERAL = 0
KIND_MATCH = 1
KIND_EOB = 2
KIND_SUBTABLE = 3

PRECODE_TABLEBITS, PRECODE_ENOUGH = 7, 128
LITLEN_TABLEBITS, LITLEN_ENOUGH = 11, 2342
OFFSET_TABLEBITS, OFFSET_ENOUGH = 8, 402


def pack(kind: int, payload: int, extra: int, consume: int) -> int:
    return (kind << 30) | (payload << 16) | (extra << 8) | consume


def _decode_results_litlen() -> np.ndarray:
    """Per-symbol (kind, payload, extra) for the litlen alphabet, packed with
    consume=0 (codeword length is OR'd in during table fill)."""
    res = np.zeros(NUM_LITLEN_SYMS, dtype=np.uint32)
    for sym in range(256):
        res[sym] = pack(KIND_LITERAL, sym, 0, 0)
    res[256] = pack(KIND_EOB, 0, 0, 0)
    for sym in range(257, 286):
        slot = sym - 257
        res[sym] = pack(
            KIND_MATCH, int(LENGTH_SLOT_BASE[slot]), int(LENGTH_SLOT_EXTRA[slot]), 0
        )
    for sym in (286, 287):
        res[sym] = pack(KIND_EOB, 1, 0, 0)  # invalid if ever decoded
    return res


def _decode_results_offset() -> np.ndarray:
    res = np.zeros(NUM_OFFSET_SYMS, dtype=np.uint32)
    from ..formats.deflate import OFFSET_SLOT_EXTRA

    for sym in range(30):
        res[sym] = pack(KIND_MATCH, sym, int(OFFSET_SLOT_EXTRA[sym]), 0)
    for sym in (30, 31):
        res[sym] = pack(KIND_EOB, 1, 0, 0)  # invalid if ever decoded
    return res


def _decode_results_precode() -> np.ndarray:
    # Precode symbols decode to themselves; extra-bit handling for 16/17/18
    # lives in the block-header decoder.
    return np.array(
        [pack(KIND_MATCH, sym, 0, 0) for sym in range(NUM_PRECODE_SYMS)],
        dtype=np.uint32,
    )


DECODE_RESULTS_LITLEN = _decode_results_litlen()
DECODE_RESULTS_OFFSET = _decode_results_offset()
DECODE_RESULTS_PRECODE = _decode_results_precode()


def build_decode_table(
    lens: np.ndarray,
    decode_results: np.ndarray,
    table_bits: int,
    enough: int,
    max_codeword_len: int,
) -> np.ndarray | None:
    """Build a packed decode table, or return None if the code is invalid.

    Follows the reference's validity rules (overfull rejected; incomplete
    accepted only for the empty code or a single len-1 codeword, which are
    mapped to a complete 1-bit code — lib/deflate_decompress.c:790-853).
    """
    lens = np.asarray(lens, dtype=np.int64)
    num_syms = lens.shape[0]
    len_counts = np.bincount(lens, minlength=max_codeword_len + 1)

    # Kraft codespace check.
    codespace_used = 0
    for l in range(1, max_codeword_len + 1):
        codespace_used = (codespace_used << 1) + int(len_counts[l])
    full = 1 << max_codeword_len

    table = np.zeros(enough, dtype=np.uint32)
    if codespace_used > full:
        return None
    if codespace_used < full:
        if codespace_used == 0:
            sym = 0  # arbitrary; the entry can never mis-decode real data
        else:
            if codespace_used != (full >> 1) or int(len_counts[1]) != 1:
                return None
            sym = int(np.flatnonzero(lens == 1)[0])
        entry = np.uint32(decode_results[sym] | 1)
        table[: 1 << table_bits] = entry
        return table

    codes = canonical_codes(lens)
    rev = reverse_bits(codes, lens.astype(np.uint32)).astype(np.int64)

    # Canonical order: by (len, symbol).
    used = np.flatnonzero(lens > 0)
    order = used[np.argsort(lens[used], kind="stable")]

    cur_sub = 1 << table_bits  # next free slot for subtables
    sub_prefix = -1
    for sym in order:
        l = int(lens[sym])
        r = int(rev[sym])
        if l <= table_bits:
            idx = np.arange(r, 1 << table_bits, 1 << l)
            table[idx] = np.uint32(int(decode_results[sym]) | l)
        else:
            prefix = r & ((1 << table_bits) - 1)
            if prefix != sub_prefix:
                # Determine this subtable's width: the longest codeword
                # sharing this prefix.  Scan remaining canonical symbols.
                sub_prefix = prefix
                remaining = order[np.searchsorted(lens[order], l, side="left"):]
                share = remaining[
                    (rev[remaining] & ((1 << table_bits) - 1)) == prefix
                ]
                sub_bits = int(lens[share].max()) - table_bits
                sub_start = cur_sub
                cur_sub += 1 << sub_bits
                if cur_sub > enough:
                    return None  # cannot happen for valid codes (ENOUGH bound)
                table[prefix] = np.uint32(
                    pack(KIND_SUBTABLE, sub_start, sub_bits, table_bits)
                )
            hi = r >> table_bits
            idx = sub_start + np.arange(hi, 1 << sub_bits, 1 << (l - table_bits))
            table[idx] = np.uint32(int(decode_results[sym]) | l)
    return table


def build_precode_table(lens: np.ndarray) -> np.ndarray | None:
    return build_decode_table(
        lens, DECODE_RESULTS_PRECODE, PRECODE_TABLEBITS, PRECODE_ENOUGH, 7
    )


def build_litlen_table(lens: np.ndarray) -> np.ndarray | None:
    return build_decode_table(
        lens, DECODE_RESULTS_LITLEN, LITLEN_TABLEBITS, LITLEN_ENOUGH, 15
    )


def build_offset_table(lens: np.ndarray) -> np.ndarray | None:
    return build_decode_table(
        lens, DECODE_RESULTS_OFFSET, OFFSET_TABLEBITS, OFFSET_ENOUGH, 15
    )
