"""Crafted raw-DEFLATE inputs for K4 (and K3): the streams whose bits,
staging-base moves and reads past the row a decoder's reader must get
exactly right.

The CPU tests (``tests/test_torch_tokenize.py``) hold K4's plain version
against interpret-mode Pallas on these sets, and ``chip_smoke.py`` holds
the CUDA kernel against the plain version on the same sets.  Every set is
one batch of B = 2 rows of W = 12288 words (the tests' one interpret-mode
shape): ``(comp uint32 [B, W], comp_len int32 [B], out_len int32 [B])``.

- stored blocks whose LEN passes the data, or jumps the cursor past the
  padded row (the next header lies past it);
- a stored block whose LEN lands the cursor exactly at, and just after, the
  first staging window's edge (word 2048), and at and just before a
  512-word edge further on;
- a crafted dynamic block with subtables in both tables (codes of 15 and
  11 bits) and paired 2-bit literals; the zlib-lax incomplete codes;
- zlib level-6 text with out_len one short and one long;
- long literal bursts (zlib's Huffman-only strategy, ~40 KB streams) that
  cross several staging-base moves;
- run-on blocks (no EOB, the all-zero codeword a literal) that decode the
  zero padding up to the row's last word W_pad - 1, which holds set bits:
  reads past the row read that word again.

``craft_dynamic_stream`` authors a dynamic block from explicit code
lengths; it is this package's copy of the JAX tests' crafter
(``tests/test_incomplete_codes.py``), byte for byte.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .corpus import REPO

B, W = 2, 12288
FILLER = b"\x03\x00"                     # an empty static final block
PRECODE_PERM = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14,
                1, 15)


def repo_text(root: Path = REPO) -> bytes:
    """This repository's SURVEY.md and PERF_NOTES.md (84 KB of text)."""
    return b"".join((root / name).read_bytes()
                    for name in ("SURVEY.md", "PERF_NOTES.md"))


def zlib_stream(raw: bytes, level: int = 6,
                strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """Raw DEFLATE of raw by zlib (memLevel 9)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(raw) + c.flush()


def stored_block(length: int, data: bytes, final: bool = True) -> bytes:
    """A stored block's header with LEN = length, then data (whatever its
    length)."""
    return bytes([int(final)]) + struct.pack("<HH", length,
                                             length ^ 0xFFFF) + data


# ---- the dynamic-block crafter -------------------------------------------

def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """LSB-first (bit-reversed) canonical codewords (RFC 1951 3.2.2)."""
    max_len = int(lens.max()) if lens.size else 0
    bl_count = np.bincount(lens, minlength=max_len + 1)
    bl_count[0] = 0
    codes = np.zeros_like(lens)
    code = 0
    next_code = [0] * (max_len + 1)
    for ln in range(1, max_len + 1):
        code = (code + int(bl_count[ln - 1])) << 1
        next_code[ln] = code
    for sym in range(lens.size):
        ln = int(lens[sym])
        if ln:
            c = next_code[ln]
            next_code[ln] += 1
            codes[sym] = int(f"{c:0{ln}b}"[::-1], 2)
    return codes


def rle_lens(all_lens: list[int]):
    """(presym, extra_bits, extra_val) items for a lens array (RFC 1951
    3.2.7: 16 copies the previous length, 17 and 18 are zero runs)."""
    items = []
    i = 0
    n = len(all_lens)
    while i < n:
        v = all_lens[i]
        run = 1
        while i + run < n and all_lens[i + run] == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                t = min(r, 138)
                items.append((18, 7, t - 11))
                r -= t
            if r >= 3:
                items.append((17, 3, r - 3))
                r = 0
            items.extend((0, 0, 0) for _ in range(r))
        else:
            items.append((v, 0, 0))
            r = run - 1
            while r >= 3:
                t = min(r, 6)
                items.append((16, 2, t - 3))
                r -= t
            items.extend((v, 0, 0) for _ in range(r))
        i += run
    return items


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal codeword lengths limited to max_len (package-merge); one
    used symbol gets a partner, none gives symbols 0 and 1 length 1."""
    freqs = np.asarray(freqs, dtype=np.int64)
    used = np.flatnonzero(freqs > 0)
    n = used.shape[0]
    lens = np.zeros(freqs.shape[0], dtype=np.int32)
    if n == 0:
        lens[:2] = 1
        return lens
    if n == 1:
        s = int(used[0])
        lens[s] = 1
        lens[1 if s == 0 else 0] = 1
        return lens
    if n > (1 << max_len):
        raise ValueError("too many symbols for length limit")
    order = np.argsort(freqs[used], kind="stable")
    item_w = freqs[used][order]
    item_c = np.eye(n, dtype=np.int32)
    level_w, level_c = item_w.copy(), item_c.copy()
    for _ in range(max_len - 1):
        m = level_w.shape[0] // 2
        pack_w = level_w[: 2 * m : 2] + level_w[1 : 2 * m : 2]
        pack_c = level_c[: 2 * m : 2] + level_c[1 : 2 * m : 2]
        w = np.concatenate([item_w, pack_w])
        c = np.concatenate([item_c, pack_c], axis=0)
        o = np.argsort(w, kind="stable")
        level_w, level_c = w[o], c[o]
    lens[used[order]] = level_c[: 2 * (n - 1)].sum(axis=0)
    return lens


def craft_dynamic_stream(litlen_lens: dict[int, int],
                         offset_lens: dict[int, int], body,
                         bfinal: bool = True) -> bytes:
    """One dynamic-Huffman block from explicit code lengths (symbol ->
    length, all others 0: incomplete codes allowed).  body is a list of
    ("lit", sym), ("match", len_sym, len_extra_bits, len_extra_val,
    off_sym, off_extra_bits, off_extra_val) and ("eob",) items."""
    num_litlen = max(257, max(litlen_lens) + 1 if litlen_lens else 0)
    num_offset = max(1, max(offset_lens) + 1 if offset_lens else 0)
    ll = np.zeros(num_litlen, np.int64)
    for s, ln in litlen_lens.items():
        ll[s] = ln
    of = np.zeros(num_offset, np.int64)
    for s, ln in offset_lens.items():
        of[s] = ln
    ll_codes, of_codes = canonical_codes(ll), canonical_codes(of)
    items = rle_lens(list(ll) + list(of))
    pre_freq = np.zeros(19, np.int64)
    for sym, _, _ in items:
        pre_freq[sym] += 1
    pre_lens = package_merge_lengths(pre_freq, 7)
    pre_codes = canonical_codes(pre_lens)
    num_explicit = 19
    while num_explicit > 4 and pre_lens[PRECODE_PERM[num_explicit - 1]] == 0:
        num_explicit -= 1

    acc, nacc = 0, 0

    def put(value, nbits):
        nonlocal acc, nacc
        acc |= int(value) << nacc
        nacc += int(nbits)

    put(int(bfinal), 1)
    put(2, 2)                              # BTYPE: dynamic
    put(num_litlen - 257, 5)
    put(num_offset - 1, 5)
    put(num_explicit - 4, 4)
    for i in range(num_explicit):
        put(pre_lens[PRECODE_PERM[i]], 3)
    for sym, xbits, xval in items:
        put(pre_codes[sym], pre_lens[sym])
        put(xval, xbits)
    for item in body:
        if item[0] == "lit":
            put(ll_codes[item[1]], ll[item[1]])
        elif item[0] == "eob":
            put(ll_codes[256], ll[256])
        else:
            _, ls, lxb, lxv, os_, oxb, oxv = item
            put(ll_codes[ls], ll[ls])
            put(lxv, lxb)
            put(of_codes[os_], of[os_])
            put(oxv, oxb)
    return acc.to_bytes((nacc + 7) // 8, "little")


def deep_stream() -> bytes:
    """A dynamic block whose litlen code reaches 15 bits and whose offset
    code reaches 11 (subtables in both tables), with paired 2-bit
    literals, 78 bytes of output."""
    ll = np.zeros(288, np.int64)
    ll[[ord("a"), ord("b")]] = 2
    ll[256], ll[257] = 3, 4
    ll[258:274] = 8
    free = np.flatnonzero(ll == 0)
    deep = [15, 15, 14, 13, 12, 11, 10] + [9] * 127
    ll[free[:len(deep)]] = deep
    of = {k: k + 1 for k in range(11)} | {11: 11}
    lits = [("lit", s) for s in (ord("a"), ord("b"), *free[:7], ord("a"))]
    body = lits * 6 + [("match", 257, 0, 0, 0, 0, 0),      # 3 at 1
                       ("match", 258, 0, 0, 11, 4, 3),     # 4 at 52
                       ("match", 260, 0, 0, 10, 4, 5),     # 6 at 38
                       ("match", 259, 0, 0, 9, 3, 2),      # 5 at 27
                       ("eob",)]
    lens = {int(s): int(n) for s, n in enumerate(ll) if n}
    return craft_dynamic_stream(lens, of, body)


def run_on_stream(bits: int, n: int, bfinal: bool = True) -> bytes:
    """A dynamic block without EOB: 2**bits - 1 literals from "a" (or "b"
    for bits > 1) and the EOB, all codewords `bits` long, then n times the
    last literal.  The all-zero codeword is a literal, so a decoder runs
    on through zero padding."""
    syms = "a" if bits == 1 else "bcdefgh"[:(1 << bits) - 1]
    lens = {ord(ch): bits for ch in syms} | {256: bits}
    return craft_dynamic_stream(lens, {}, [("lit", ord(syms[-1]))] * n,
                                bfinal)


# ---- the sets ------------------------------------------------------------

def pack_rows(streams, out_lens, comp_lens=None, last_words=None):
    """(comp, comp_len, out_len) of one B x W batch: each stream in its
    row, zero-padded, FILLER rows after them.  comp_lens, if given,
    replaces the stream lengths; last_words, if given, is written to each
    row's last word (W_pad - 1, since W is a multiple of 1024)."""
    streams = list(streams) + [FILLER] * (B - len(streams))
    olen = np.asarray(list(out_lens) + [0] * (B - len(out_lens)), np.int32)
    comp = np.zeros((B, W), np.uint32)
    clen = np.zeros(B, np.int32)
    for k, s in enumerate(streams):
        comp[k, : -(-len(s) // 4)] = np.frombuffer(s + b"\0" * (-len(s) % 4),
                                                   np.uint32)
        clen[k] = len(s) if comp_lens is None else comp_lens[k]
    if last_words is not None:
        comp[:, -1] = last_words
    return comp, clen, olen


def stored_past_the_data():
    """LEN past the 100 data bytes: accepted (no staging bound)."""
    data = bytes(range(100))
    return pack_rows([stored_block(5000, data), stored_block(60000, data)],
                     [65536, 65536])


def stored_past_the_padded_row():
    """Non-final stored blocks whose LEN jumps the cursor past the padded
    row (4 * W bytes): the next header lies past the row."""
    data = bytes(range(100))
    return pack_rows([stored_block(60000, data, False),
                      stored_block(40000, data, False)], [65536, 65536])


def _stored_then_fixed(land_bit: int, text: bytes) -> bytes:
    """A non-final stored block whose LEN puts the next header at bit
    land_bit (a multiple of 8), then a final Z_FIXED block of text."""
    ln = (land_bit - 40) // 8
    return stored_block(ln, text[:ln], False) + zlib_stream(
        text[:3000], 6, zlib.Z_FIXED)


def stored_to_the_window_edge(text: bytes):
    """The cursor lands exactly at the first staging window's edge (word
    2048) and one byte after it."""
    edge = 2048 * 32
    streams = [_stored_then_fixed(edge, text),
               _stored_then_fixed(edge + 8, text)]
    return pack_rows(streams, [(edge - 40) // 8 + 3000,
                               (edge - 32) // 8 + 3000])


def stored_to_a_segment_edge(text: bytes):
    """The cursor lands at a 512-word edge further on (word 2560) and one
    byte before it, so the next header straddles the edge."""
    edge = 2560 * 32
    streams = [_stored_then_fixed(edge, text),
               _stored_then_fixed(edge - 8, text)]
    return pack_rows(streams, [(edge - 40) // 8 + 3000,
                               (edge - 48) // 8 + 3000])


def deep_subtables():
    s = deep_stream()
    return pack_rows([s, s], [78, 77])


def incomplete_codes():
    """An offset code of no codewords and litlen codes of one length-1
    codeword (zlib-lax)."""
    s1 = craft_dynamic_stream({ord("a"): 1, 256: 1}, {},
                              [("lit", ord("a"))] * 3 + [("eob",)])
    s2 = craft_dynamic_stream(
        {ord("x"): 1, 256: 2, 257: 2}, {0: 1},
        [("lit", ord("x")), ("match", 257, 0, 0, 0, 0, 0), ("eob",)])
    return pack_rows([s1, s2], [3, 4])


def out_len_one_off(text: bytes):
    raw = (text * 2)[5000:25000]
    s = zlib_stream(raw)
    return pack_rows([s, s], [len(raw) - 1, len(raw) + 1])


def _huffman_only(raw: bytes, limit: int) -> tuple[bytes, bytes]:
    """(raw', stream): the longest prefix raw' of raw, in steps of 1000
    bytes, whose Huffman-only stream is at most limit bytes."""
    n = len(raw)
    while True:
        s = zlib_stream(raw[:n], 6, zlib.Z_HUFFMAN_ONLY)
        if len(s) <= limit:
            return raw[:n], s
        n -= 1000


def bursts_across_staging_moves(text: bytes, seed: int = 17):
    """Literal-only streams of text and of skewed random bytes, each up to
    the 40960 bytes the row allows: their bursts cross the staging-base
    moves at words 2045, 3069, ... ."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 65)
    skew = rng.choice(np.arange(64, dtype=np.uint8) + 40, size=80000,
                      p=p / p.sum()).tobytes()
    limit = 4 * (W - 2048)
    raws, streams = zip(*(_huffman_only(r, limit)
                          for r in ((text * 2)[:80000], skew)))
    return pack_rows(streams, [len(r) for r in raws])


def run_on_into_the_last_word():
    """Run-on blocks after a 40 900-byte stored block, comp_len the most
    the row allows (so the guard lies at W_pad): the literal run decodes
    the zero padding up to word W_pad - 1, which holds set bits, and reads
    past the row read it again.  With 1-bit codes its top bit is the EOB;
    with 3-bit codes the run ends where its bits give one, or at the
    guard."""
    clen = 4 * (W - 2048)
    streams = [stored_block(40900, bytes(40900), False)
               + run_on_stream(bits, 3) for bits in (1, 3)]
    return pack_rows(streams, [1 << 20, 1 << 20], comp_lens=[clen, clen],
                     last_words=[0x80000000, 0x12345678])


def crafted_sets(text: bytes) -> dict:
    """Every set of this module: {name: (comp, comp_len, out_len)}."""
    return {
        "stored LEN past the data": stored_past_the_data(),
        "stored LEN past the padded row": stored_past_the_padded_row(),
        "stored jump to the window edge": stored_to_the_window_edge(text),
        "stored jump to a segment edge": stored_to_a_segment_edge(text),
        "deep subtables": deep_subtables(),
        "incomplete codes": incomplete_codes(),
        "out_len one off": out_len_one_off(text),
        "bursts across staging moves": bursts_across_staging_moves(text),
        "run-on into the last word": run_on_into_the_last_word(),
    }
