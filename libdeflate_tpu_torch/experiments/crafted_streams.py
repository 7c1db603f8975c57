"""Crafted raw-DEFLATE inputs for K4 and K3: the streams whose bits,
staging-base moves, reads past the row and LZ-window edges a decoder must
get exactly right.

The CPU tests hold the plain versions against interpret-mode Pallas on
these sets (``tests/test_torch_tokenize.py`` K4's,
``tests/test_torch_decode_crafted.py`` K3's), and ``chip_smoke.py`` holds
the CUDA kernels against the plain versions on the same sets.

K4's sets (``crafted_sets``) are each one batch of B = 2 rows of W = 12288
words (the tests' one interpret-mode shape): ``(comp uint32 [B, W],
comp_len int32 [B], out_len int32 [B])``.

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

K3's sets (``decode_sets``) are up to DEC_B = 4 streams each, with their
out_lens and their unknown-size capacities, packed by ``pack_rows`` into
4 rows of W words and decoded into 81920 bytes a row: matches of every
distance 1-40 at lengths 3, 31, 32, 33 and 258; distance 32768 into the
half flushed before; items across 32 KiB boundaries; stored blocks longer
than the 16 KiB input ring and onto its segment edges; stored LEN past the
data; output past out_bytes; failures in the middle of a window.  They are
token lists encoded by ``blocks_stream``, whose dynamic blocks take the
package-merge code lengths of their tokens.

``craft_dynamic_stream`` authors a dynamic block from explicit code
lengths; it is this package's copy of the JAX tests' crafter
(``tests/test_incomplete_codes.py``), byte for byte, through the bit
writer that also joins ``blocks_stream``'s blocks.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..decompress.tables import LEN_BASE, LEN_EXTRA, OFF_BASE, OFF_EXTRA
from .corpus import REPO

B, W = 2, 12288
# K3's sets: the words batch of tests/test_torch_decode.py, B = 4 rows of
# W = 12288 words decoded into 81920 bytes a row
DEC_B, DEC_OUT_BYTES = 4, 81920
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


class BitWriter:
    """DEFLATE's LSB-first bit order: put(value, nbits) appends the low
    nbits of value; align() pads with zeros to a byte boundary; whole bytes
    move out of the accumulator as they fill."""

    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value, nbits):
        self.acc |= int(value) << self.n
        self.n += int(nbits)
        if self.n >= 64:
            k = self.n >> 3
            self.out += (self.acc & ((1 << 8 * k) - 1)).to_bytes(k, "little")
            self.acc >>= 8 * k
            self.n -= 8 * k

    def align(self):
        self.n = -(-self.n // 8) * 8

    def bytes(self) -> bytes:
        return bytes(self.out) + self.acc.to_bytes((self.n + 7) // 8,
                                                   "little")


def put_dynamic_block(bw: BitWriter, litlen_lens: dict[int, int],
                      offset_lens: dict[int, int], body,
                      bfinal: bool = True) -> None:
    """One dynamic-Huffman block from explicit code lengths (symbol ->
    length, all others 0: incomplete codes allowed), appended to bw.  body
    is a list of ("lit", sym), ("match", len_sym, len_extra_bits,
    len_extra_val, off_sym, off_extra_bits, off_extra_val) and ("eob",)
    items."""
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

    put = bw.put
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


def craft_dynamic_stream(litlen_lens: dict[int, int],
                         offset_lens: dict[int, int], body,
                         bfinal: bool = True) -> bytes:
    """One dynamic-Huffman block (``put_dynamic_block``) as a stream of
    its own, zero-padded to a byte."""
    bw = BitWriter()
    put_dynamic_block(bw, litlen_lens, offset_lens, body, bfinal)
    return bw.bytes()


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

def pack_rows(streams, out_lens, comp_lens=None, last_words=None, rows=B):
    """(comp, comp_len, out_len) of one rows x W batch: each stream in its
    row, zero-padded, FILLER rows after them.  comp_lens, if given,
    replaces the stream lengths; last_words, if given, is written to each
    row's last word (W_pad - 1, since W is a multiple of 1024)."""
    streams = list(streams) + [FILLER] * (rows - len(streams))
    olen = np.asarray(list(out_lens) + [0] * (rows - len(out_lens)), np.int32)
    comp = np.zeros((rows, W), np.uint32)
    clen = np.zeros(rows, np.int32)
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


def incomplete_code_streams() -> list[bytes]:
    """An offset code of no codewords and litlen codes of one length-1
    codeword (zlib-lax), 3 and 4 bytes of output."""
    s1 = craft_dynamic_stream({ord("a"): 1, 256: 1}, {},
                              [("lit", ord("a"))] * 3 + [("eob",)])
    s2 = craft_dynamic_stream(
        {ord("x"): 1, 256: 2, 257: 2}, {0: 1},
        [("lit", ord("x")), ("match", 257, 0, 0, 0, 0, 0), ("eob",)])
    return [s1, s2]


def incomplete_codes():
    """``incomplete_code_streams`` as one batch."""
    return pack_rows(incomplete_code_streams(), [3, 4])


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


# ---- K3's sets: output through the LZ window ------------------------------
#
# Token lists: ("lit", byte), ("match", length, dist), ("sym", litlen
# symbol without extra bits; 286 and 287 are invalid) and ("bad offset",
# length), a match whose offset symbol is 30 (invalid).  Each set is
# {name: (streams, out_lens for known-size mode, capacities for
# unknown-size mode)}, at most DEC_B streams, every stream at most the
# 40960 bytes a W = 12288 row allows.

def put_token_block(bw: BitWriter, tokens, bfinal: bool = True) -> None:
    """tokens, then the EOB, as one dynamic block whose code lengths are
    the package-merge lengths (at most 15 bits) of the tokens' symbol
    counts."""
    body = []
    ll_freq = np.zeros(288, np.int64)
    of_freq = np.zeros(32, np.int64)
    for tok in tokens:
        if tok[0] in ("lit", "sym"):
            body.append(("lit", tok[1]))
            ll_freq[tok[1]] += 1
            continue
        li = int(np.searchsorted(LEN_BASE, tok[1], side="right")) - 1
        if tok[0] == "match":
            oi = int(np.searchsorted(OFF_BASE, tok[2], side="right")) - 1
            oxb, oxv = int(OFF_EXTRA[oi]), tok[2] - int(OFF_BASE[oi])
        else:
            oi, oxb, oxv = 30, 0, 0
        body.append(("match", 257 + li, int(LEN_EXTRA[li]),
                     tok[1] - int(LEN_BASE[li]), oi, oxb, oxv))
        ll_freq[257 + li] += 1
        of_freq[oi] += 1
    body.append(("eob",))
    ll_freq[256] += 1
    ll = package_merge_lengths(ll_freq, 15)
    of = package_merge_lengths(of_freq, 15)
    put_dynamic_block(bw, {int(k): int(v) for k, v in enumerate(ll) if v},
                      {int(k): int(v) for k, v in enumerate(of) if v}, body,
                      bfinal)


def put_stored(bw: BitWriter, data: bytes, bfinal: bool = True,
               length: int | None = None) -> None:
    """A stored block of data whose LEN is length (default len(data))."""
    ln = len(data) if length is None else length
    bw.put(int(bfinal), 1)
    bw.put(0, 2)
    bw.align()
    bw.put(ln, 16)
    bw.put(ln ^ 0xFFFF, 16)
    bw.put(int.from_bytes(data, "little"), 8 * len(data))


def blocks_stream(*blocks) -> bytes:
    """Blocks joined bit to bit, the last one final: ("tokens", tokens) or
    ("stored", data[, length])."""
    bw = BitWriter()
    for i, blk in enumerate(blocks):
        final = i == len(blocks) - 1
        if blk[0] == "tokens":
            put_token_block(bw, blk[1], final)
        else:
            put_stored(bw, blk[1], final, *blk[2:])
    return bw.bytes()


def tokens_out(tokens) -> int:
    """The output bytes of valid tokens."""
    return sum(1 if t[0] == "lit" else t[1] for t in tokens)


def _lits(rng, n: int, alphabet: int = 256):
    return [("lit", int(v)) for v in rng.integers(0, alphabet, n)]


def _fill(op: int, target: int, dists):
    """Matches (and at most two literals) that take the output from op to
    exactly target, their distances cycling through dists (each <= op)."""
    toks, k = [], 0
    while op < target:
        r = target - op
        if r < 3:
            toks += [("lit", 0x5A)] * r
            break
        n = min(258, r)
        if 0 < r - n < 3:
            n = r - 3
        toks.append(("match", n, dists[k % len(dists)]))
        k += 1
        op += n
    return toks


def every_distance(seed: int = 31):
    """Matches of every distance 1-40 at lengths 3, 31, 32, 33 and 258 (a
    literal before each), from output byte 40 and from byte 20007."""
    rng = np.random.default_rng(seed)
    body = []
    for d in range(1, 41):
        for n in (3, 31, 32, 33, 258):
            body += _lits(rng, 1) + [("match", n, d)]
    a = _lits(rng, 40) + body
    b = _lits(rng, 300) + _fill(300, 20007, (300, 299, 7, 123)) + body
    return ([blocks_stream(("tokens", t)) for t in (a, b)],
            [tokens_out(a), tokens_out(b)], [DEC_OUT_BYTES] * 2)


def window_distance(seed: int = 32):
    """Matches at distance 32768 (and 32767, 32000, 16385) whose sources
    lie in the half flushed before: one at op = 32768 exactly (source byte
    0), then on to ~70000 bytes; and from op = 40000 on past the ring's
    wrap at 65536."""
    rng = np.random.default_rng(seed)
    streams, lens = [], []
    for head, start, end in ((1000, 32768, 70000), (2000, 40000, 76000)):
        toks = _lits(rng, head) + _fill(head, start, (head, head - 1))
        op = start
        dists = (32768, 32767, 32000, 16385)
        k = 0
        while op < end:
            n = 258 if k % 3 else int(rng.integers(3, 259))
            toks.append(("match", n, dists[k % len(dists)]))
            op += n
            if k % 5 == 0:
                toks += _lits(rng, 2)
                op += 2
            k += 1
        streams.append(blocks_stream(("tokens", toks)))
        lens.append(tokens_out(toks))
    return streams, lens, [DEC_OUT_BYTES] * 2


def straddling_items(seed: int = 33):
    """Items across the 32 KiB boundaries: the output brought to k bytes
    short of 32768 (k = 1, 7, 8), then a 258-byte match, a 31-byte match
    at distance 1 and the same short of 65536; and 70000 literals of a
    two-letter alphabet, paired in the table, whose single and paired
    literal items cross both boundaries."""
    rng = np.random.default_rng(seed)
    streams, lens = [], []
    for k in (1, 7, 8):
        toks = _lits(rng, 500) + _fill(500, 32768 - k, (500, 333))
        toks += [("match", 258, 77)] + _lits(rng, 3) + [("match", 31, 1)]
        toks += _fill(tokens_out(toks), 65536 - k, (32768, 4000))
        toks += [("match", 258, 32768)] + _lits(rng, 5)
        streams.append(blocks_stream(("tokens", toks)))
        lens.append(tokens_out(toks))
    toks = [("lit", 97 + int(v)) for v in rng.integers(0, 2, 70000)]
    streams.append(blocks_stream(("tokens", toks)))
    lens.append(70000)
    return streams, lens, [DEC_OUT_BYTES] * 4


def stored_longer_than_the_ring(seed: int = 34):
    """Stored blocks longer than the 16 KiB input ring, whose copies cross
    staging-base moves and 32 KiB output boundaries: 36000 bytes then
    matches back into them; a Huffman block, 30000 stored bytes from an
    odd bit, then matches; two stored blocks back to back (20000, 16385);
    33000 bytes of matches, then 39000 stored bytes across 65536."""
    rng = np.random.default_rng(seed)

    def raw(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    back = [("match", 258, 32768), ("match", 200, 30001)] + _lits(rng, 3) \
        + [("match", 40, 5)]
    head = _lits(rng, 700) + _fill(700, 5001, (700, 3))
    runs = _lits(rng, 64) + _fill(64, 33000, (64,))
    blocks = [(("stored", raw(36000)), ("tokens", back)),
              (("tokens", head), ("stored", raw(30000)), ("tokens", back)),
              (("stored", raw(20000)), ("stored", raw(16385)),
               ("tokens", back)),
              (("tokens", runs), ("stored", raw(39000)))]
    streams = [blocks_stream(*bl) for bl in blocks]
    lens = [sum(len(b[1]) if b[0] == "stored" else tokens_out(b[1])
                for b in bl) for bl in blocks]
    return streams, lens, [DEC_OUT_BYTES] * 4


def stored_to_ring_edges(text: bytes):
    """Stored blocks that land the next (Z_FIXED) block's header one byte
    before and at a 512-word ring segment edge (word 2560), at the ring's
    wrap (word 4096) and one byte past word 4608."""
    edges = (2560 * 32 - 8, 2560 * 32, 4096 * 32, 4608 * 32 + 8)
    return ([_stored_then_fixed(e, text) for e in edges],
            [(e - 40) // 8 + 3000 for e in edges], [DEC_OUT_BYTES] * 4)


def stored_len_past_the_data(seed: int = 35):
    """Stored LEN 5000 and 60000 over 100 data bytes, the copy reading the
    zero padding until the staged window ends it; and LEN 60000 after
    20000 bytes of a Huffman block, which fails in the middle of a
    window."""
    rng = np.random.default_rng(seed)
    data = bytes(range(100))
    toks = _lits(rng, 300) + _fill(300, 20000, (300, 17))
    streams = [stored_block(5000, data), stored_block(60000, data),
               blocks_stream(("tokens", toks), ("stored", data, 60000))]
    return streams, [5000, 60000, 80000], [DEC_OUT_BYTES] * 3


def past_out_bytes(seed: int = 36):
    """Output past out_bytes (81920): 90000 and 81921 bytes with out_len
    and capacity above it, and 90000 bytes against a capacity of 85000
    (BAD_DATA when a match passes it)."""
    rng = np.random.default_rng(seed)
    streams, lens = [], []
    for n in (90000, 81921, 90000):
        toks = _lits(rng, 2000) + _fill(2000, n, (2000, 1999, 1000))
        streams.append(blocks_stream(("tokens", toks)))
        lens.append(n)
    return streams, [90000, 81921, 85000], [100000, 100000, 85000]


def failure_mid_window(seed: int = 37):
    """A failure with the output in the middle of a window: a distance past
    the output at 20000 bytes, the invalid litlen symbol 286 at 50000, the
    invalid offset symbol 30 at 60001, and out_len 47000 under 90000
    bytes of output."""
    rng = np.random.default_rng(seed)
    head = _lits(rng, 300)

    def upto(n):
        return head + _fill(300, n, (300, 211))
    tails = ([("match", 10, 25000)] + _lits(rng, 5), [("sym", 286)],
             [("bad offset", 10)], [])
    ends = (20000, 50000, 60001, 90000)
    streams = [blocks_stream(("tokens", upto(n) + t))
               for n, t in zip(ends, tails)]
    return streams, [80000, 80000, 80000, 47000], [DEC_OUT_BYTES] * 3 + [47000]


def decode_sets(text: bytes) -> dict:
    """Every K3 set: {name: (streams, out_lens, capacities)}."""
    return {
        "matches at distances 1-40": every_distance(),
        "distance 32768 into the flushed half": window_distance(),
        "items across 32 KiB boundaries": straddling_items(),
        "stored blocks longer than the ring": stored_longer_than_the_ring(),
        "stored jumps to ring edges": stored_to_ring_edges(text),
        "stored LEN past the data": stored_len_past_the_data(),
        "output past out_bytes": past_out_bytes(),
        "failure in the middle of a window": failure_mid_window(),
    }
