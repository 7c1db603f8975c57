"""The FSM decoder's cases: streams, their batches and the pins.

``tests/test_torch_fsm.py`` holds the plain FSM decoder
(``decompress/fsm.py``) to the JAX package's ``decompress/tpu.py`` on these
sets, ``tests/pin_fsm.py`` pins the JAX decoder's 4-tuples of the pinned
sets into ``fsm_pins.json``, and ``chip_smoke.py`` holds the kernel (F1)
to its plain version and to the pins on the card.  Every set is decoded in
batches of B = 8 rows of N = 8192 bytes into OUT = 16384 bytes a row, the
shape of ``tests/test_tpu_decode.py``, so that the JAX decoder compiles
once.  A case is (name, stream, in_len): the stream's first N bytes go in
its row, and in_len may differ from its length.  ``repack`` cuts a batch
to rows of ODD_N bytes (unaligned row starts, decoded into ODD_OUT), and
``crafted_batches`` turns K3's crafted sets into FSM batches.

- ``zlib_set``: zlib levels 0, 1, 6 and 9, Z_FIXED, Z_HUFFMAN_ONLY and
  Z_RLE of repository text, and level 6 of random bytes;
- ``damaged_set``: like ``chip_smoke.damaged_streams``, eight zlib-6
  streams (every fourth Z_FIXED) each with 1-3 bit flips, a byte
  overwritten, a cut in the middle and a cut of 1-3 bytes at the end;
- ``incomplete_set``: the zlib-lax incomplete codes
  (``crafted_streams.incomplete_codes`` and the streams of
  ``tests/test_incomplete_codes.py``), and the shapes that are rejected;
- ``edges_set``: the edges of the kernel's design (F1's root widths R =
  11 for litlen and 10 for offsets, its 2048-byte ring segments): literals,
  length and offset symbols whose codes are R, R + 1 and 15 bits long;
  offsets of 25 and 27 bits (code and extra bits) each before a literal
  of a long code;
  stored blocks that jump the input cursor across ring segments and land
  the next header on a segment edge, one byte before and one past it;
  stored blocks of LEN 0-3 in a row (the jump stays within the bit
  buffer); matches of every distance 1-40 and length 258 right after a
  stored block;
- ``trap_set``: one crafted case for each place where the decoder's
  bounds show: in_len 0, N, past N and negative, an EOB and a literal in
  the 49-bit overread, an empty precode, stored LEN past out_cap (with the
  input whole and short), a bad NLEN, stored LEN past the input, RLE
  symbol 16 first, a repeat past the lengths, litlen symbols 286/287 and
  offset symbols 30/31 used, a match before the output's start, matches
  whose offset is below their length, output past out_cap by a literal
  and by a match, BTYPE 3 and an overfull precode.
"""

from __future__ import annotations

import hashlib
import zlib

import numpy as np

from . import crafted_streams as cs

B, N, OUT = 8, 8192, 16384
PINNED_SETS = ("damaged", "incomplete", "traps", "edges")
SEGMENT = 2048   # bytes a segment of F1's input ring
ODD_N, ODD_OUT = 8191, 16383     # a repacked batch: unaligned rows
DAMAGE_SEED = 7


def zlib_set(text: bytes) -> list:
    rand = np.random.default_rng(3).integers(0, 256, 5000, np.uint8)
    # level 0 stores: 8000 bytes, so that the stream fits its row
    out = [(f"zlib level {lv}", cs.zlib_stream(text[:8000 if lv == 0 else
                                                    12000], lv))
           for lv in (0, 1, 6, 9)]
    out += [("Z_FIXED", cs.zlib_stream(text[3000:16000], 6, zlib.Z_FIXED)),
            ("Z_HUFFMAN_ONLY",
             cs.zlib_stream(text[:6000], 6, zlib.Z_HUFFMAN_ONLY)),
            ("Z_RLE", cs.zlib_stream(b"a" * 3000 + text[:6000], 6,
                                     zlib.Z_RLE)),
            ("random bytes", cs.zlib_stream(rand.tobytes(), 6))]
    return [(name, s, len(s)) for name, s in out]


def damage(streams, seed: int) -> list[bytes]:
    """Each stream with 1-3 bit flips, with a byte overwritten, cut in the
    middle and cut by 1-3 bytes (``chip_smoke.damaged_streams``)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in streams:
        for kind in range(4):
            b = bytearray(s)
            if kind == 0:
                for _ in range(int(rng.integers(1, 4))):
                    j = int(rng.integers(0, 8 * len(b)))
                    b[j // 8] ^= 1 << (j % 8)
            elif kind == 1:
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            elif kind == 2:
                b = b[:int(rng.integers(1, len(b)))]
            else:
                b = b[:len(b) - int(rng.integers(1, 4))]
            out.append(bytes(b))
    return out


def damaged_set(text: bytes) -> list:
    rng = np.random.default_rng(DAMAGE_SEED)
    sources = []
    for i in range(8):
        off = int(rng.integers(0, len(text) - 14000))
        sources.append(cs.zlib_stream(
            text[off:off + 14000], 6,
            zlib.Z_FIXED if i % 4 == 3 else zlib.Z_DEFAULT_STRATEGY))
    return [(f"damaged {k}", s, len(s))
            for k, s in enumerate(damage(sources, DAMAGE_SEED + 1))]


def _undefined_codeword_of_singleton() -> bytes:
    """The singleton-EOB header followed by the undefined codeword '1'
    (``tests/test_incomplete_codes.py``): accepted as the EOB."""
    w = cs.BitWriter()
    w.put(1, 1)
    w.put(2, 2)
    w.put(0, 5)
    w.put(0, 5)
    pre = np.zeros(19, np.int64)
    pre[18], pre[0], pre[1] = 1, 2, 2
    codes = cs.canonical_codes(pre)
    n_exp = 19
    while n_exp > 4 and pre[cs.PRECODE_PERM[n_exp - 1]] == 0:
        n_exp -= 1
    w.put(n_exp - 4, 4)
    for i in range(n_exp):
        w.put(int(pre[cs.PRECODE_PERM[i]]), 3)
    for run in (138, 118):
        w.put(int(codes[18]), 1)
        w.put(run - 11, 7)
    w.put(int(codes[1]), 2)
    w.put(int(codes[0]), 2)
    w.put(1, 1)
    return w.bytes()


def incomplete_set() -> list:
    c = cs.craft_dynamic_stream
    out = [(f"lax: incomplete_codes row {k}", st)
           for k, st in enumerate(cs.incomplete_code_streams())]
    out += [("lax: empty offset code",
             c({65: 1, 66: 2, 256: 2}, {},
               [("lit", 65), ("lit", 66), ("lit", 65), ("lit", 65),
                ("eob",)])),
            ("lax: singleton EOB", c({256: 1}, {}, [("eob",)])),
            ("lax: singleton offset code",
             c({255: 1, 256: 2, 257: 2}, {0: 1},
               [("lit", 255), ("match", 257, 0, 0, 0, 0, 0), ("eob",)])),
            ("lax: singleton offset symbol 1",
             c({254: 1, 255: 2, 256: 3, 257: 3}, {1: 1},
               [("lit", 254), ("lit", 255), ("match", 257, 0, 0, 1, 0, 0),
                ("eob",)])),
            ("complete singleton pair",
             c({120: 1, 256: 1}, {}, [("lit", 120), ("lit", 120),
                                      ("eob",)])),
            ("rejected: two 2-bit litlen codewords",
             c({65: 2, 256: 2}, {}, [("lit", 65), ("eob",)])),
            ("rejected: empty litlen code", c({}, {0: 1}, [])),
            ("lax: undefined codeword of a singleton",
             _undefined_codeword_of_singleton())]
    return [(name, st, len(st)) for name, st in out]


def _header(bw, num_litlen: int, num_offsets: int, items) -> None:
    """A final dynamic block's header from explicit RLE items (presym,
    extra bits, extra value), whatever they mean; the precode's lengths
    are the package-merge lengths of the items' symbols."""
    freq = np.zeros(19, np.int64)
    for sym, _, _ in items:
        freq[sym] += 1
    pre = cs.package_merge_lengths(freq, 7)
    codes = cs.canonical_codes(pre)
    bw.put(1, 1)
    bw.put(2, 2)
    bw.put(num_litlen - 257, 5)
    bw.put(num_offsets - 1, 5)
    bw.put(15, 4)
    for i in range(19):
        bw.put(int(pre[cs.PRECODE_PERM[i]]), 3)
    for sym, xb, xv in items:
        bw.put(int(codes[sym]), int(pre[sym]))
        bw.put(xv, xb)


def _static(body: bytes) -> bytes:
    """A final static block of literals, then its EOB."""
    bw = cs.BitWriter()
    bw.put(1, 1)
    bw.put(1, 2)
    for ch in body:
        code = ch + 0x30 if ch < 144 else ch - 144 + 0x190
        nb = 8 if ch < 144 else 9
        bw.put(int(f"{code:0{nb}b}"[::-1], 2), nb)
    bw.put(0, 7)
    return bw.bytes()


def trap_set(text: bytes) -> list:
    rng = np.random.default_rng(11)
    z = cs.zlib_stream(text[:4000], 6)
    stored_n = cs.stored_block(N - 5, rng.integers(0, 256, N - 5,
                                                   np.uint8).tobytes())
    out = [("in_len 0, empty", b"", 0),
           ("in_len 0 over a stream", z, 0),
           ("in_len N: a stored block to the row's end", stored_n, N),
           ("in_len N: stored LEN 3 past the row",
            cs.stored_block(N - 2, stored_n[5:]), N),
           ("in_len past N: stored LEN into the zeros",
            cs.stored_block(N + 50, stored_n[5:]), N + 60),
           ("in_len -1", z, -1),
           ("in_len -7", z, -7),
           ("in_len -100", z, -100)]
    lits = _static(text[:200])
    # the static EOB is 7 zero bits: cut before it, it decodes from the
    # zeros of the overread and the stream ends past its last bit
    out += [("static EOB in the overread", lits[:-1], len(lits) - 1),
            ("static stream cut by 7 bytes", lits[:-7], len(lits) - 7)]
    run_on = cs.run_on_stream(1, 30, bfinal=True)
    out += [("run-on literals into the overread", run_on, len(run_on)),
            ("run-on literals, 2-bit code",
             cs.run_on_stream(2, 50, bfinal=True), 9)]
    bw = cs.BitWriter()
    bw.put(1, 1)
    bw.put(2, 2)
    bw.put(0, 14)                        # HLIT, HDIST, HCLEN 0: 4 zero
    bw.put(0, 12)                        # precode lengths
    empty_pre = bw.bytes() + bytes(40) + b"\xff" * 8
    out += [("empty precode: zeros decode literal 0", empty_pre,
             len(empty_pre)),
            ("empty precode, short input", empty_pre, 20)]
    big = cs.stored_block(20000, b"x" * 100)
    out += [("stored LEN past out_cap, input whole", big, 20005),
            ("stored LEN past out_cap, input short", big, len(big)),
            ("stored bad NLEN", b"\x01\x10\x00\x10\x00" + bytes(16), 21),
            ("stored LEN past the input",
             cs.stored_block(300, b"y" * 100), 105),
            ("stored then static",
             cs.stored_block(10, b"0123456789", False) + lits,
             15 + len(lits)),
            ("BTYPE 3", b"\x07" + bytes(10), 11)]
    for name, items, nl, no in (
            ("RLE symbol 16 first", [(16, 2, 0)] + [(8, 0, 0)] * 300, 257,
             1),
            ("RLE repeat past the lengths",
             [(8, 0, 0)] * 250 + [(18, 7, 20)], 257, 1)):
        bw = cs.BitWriter()
        _header(bw, nl, no, items)
        bw.put(0x5A5A5A, 24)
        s = bw.bytes()
        out.append((name, s, len(s)))
    c = cs.craft_dynamic_stream
    out += [(name, s, len(s)) for name, s in (
        ("litlen symbol 286 used",
         c({65: 2, 256: 2, 286: 2, 287: 2}, {0: 1},
           [("lit", 65), ("lit", 286), ("eob",)])),
        ("litlen symbol 287 used",
         c({65: 2, 256: 2, 286: 2, 287: 2}, {0: 1},
           [("lit", 65), ("lit", 287), ("eob",)])),
        ("offset symbol 30 used",
         c({65: 1, 256: 2, 257: 2}, {0: 2, 29: 2, 30: 2, 31: 2},
           [("lit", 65), ("match", 257, 0, 0, 30, 0, 0), ("eob",)])),
        ("offset symbol 31 used",
         c({65: 1, 256: 2, 257: 2}, {0: 2, 29: 2, 30: 2, 31: 2},
           [("lit", 65), ("match", 257, 0, 0, 31, 0, 0), ("eob",)])),
        ("match before the output's start",
         c({65: 1, 256: 2, 257: 2}, {3: 1},
           [("lit", 65), ("match", 257, 0, 0, 3, 0, 0), ("eob",)])),
        ("matches with offset below length",
         cs.blocks_stream(("tokens", [("lit", 97), ("lit", 98),
                                      ("match", 40, 2), ("lit", 99),
                                      ("match", 258, 3), ("match", 17, 1)]))),
        ("output past out_cap by a literal",
         cs.zlib_stream((b"abcd" * OUT)[:OUT + 40], 6, zlib.Z_HUFFMAN_ONLY)),
        ("output past out_cap by a match",
         cs.zlib_stream(b"ab" * (OUT // 2 + 300), 6)),
        ("overfull precode", _overfull_precode()))]
    return out


def _overfull_precode() -> bytes:
    bw = cs.BitWriter()
    bw.put(1, 1)
    bw.put(2, 2)
    bw.put(0, 10)
    bw.put(15, 4)
    for _ in range(19):
        bw.put(1, 3)                     # 19 codewords of 1 bit
    bw.put(0xFFFF, 16)
    return bw.bytes()


# complete codes of one symbol at each length 1-14 and two at 15; the
# offset code's symbol k is k + 1 bits long (14 and 15 both 15)
_DEEP_OFFSETS = {k: min(k + 1, 15) for k in range(16)}
_DEEP_LITERALS = dict(zip((97, 257, 256, *range(98, 111)),
                          (*range(1, 15), 15, 15)))
_DEEP_LENGTHS = dict(zip((97, 98, 256, *range(99, 106), 266, 270, 274, 278,
                          284, 285), (*range(1, 15), 15, 15)))


def _deep_literals() -> bytes:
    """Literals of every code length 1-15 (105, 106, 109 and 110 at 11,
    12, 15 and 15 bits), then matches through offset symbols 9, 10, 14 and
    15 (10, 11, 15 and 15 bits)."""
    lits = [("lit", s) for s in (97, 98, 99, 100, 101, 102, 103, 104, 105,
                                 106, 107, 108, 109, 110)] * 20
    matches = [("match", 257, 0, 0, osym, oxb, oxv)
               for osym, oxb, oxv in ((9, 3, 3), (10, 4, 5), (14, 6, 40),
                                      (15, 6, 63), (9, 3, 0), (15, 6, 0))]
    return cs.craft_dynamic_stream(_DEEP_LITERALS, _DEEP_OFFSETS,
                                   lits + matches * 4 + lits[:30] + [("eob",)])


def _deep_lengths() -> bytes:
    """Length symbols of code lengths 11-15 (266, 270 at R, R + 1; 284 and
    285 at 15 bits) with their extra bits, at offsets of 10, 11 and 15
    bits."""
    lits = [("lit", s) for s in range(97, 106)] * 30
    matches = []
    for lsym, lxb, lxv in ((266, 1, 1), (270, 2, 3), (274, 3, 5),
                           (278, 4, 9), (284, 5, 30), (285, 0, 0),
                           (284, 5, 0)):
        for osym, oxb, oxv in ((9, 3, 1), (10, 4, 7), (14, 6, 11)):
            matches.append(("match", lsym, lxb, lxv, osym, oxb, oxv))
    return cs.craft_dynamic_stream(_DEEP_LENGTHS, _DEEP_OFFSETS,
                                   lits + matches * 3 + [("eob",)])


def _far_offsets() -> bytes:
    """Matches whose offset takes 27 or 25 bits (a 15-bit code and 12 extra
    bits, a 14-bit code and 11), each followed by a literal of an 11-, 12-
    or 15-bit code: the next lookup after the longest offsets."""
    ll = dict(zip((97, 285, 257, 256, *range(98, 104), *range(105, 111)),
                  (*range(1, 15), 15, 15)))
    of = {**{k: k + 1 for k in range(13)}, 25: 14, 26: 15, 27: 15}
    body = [("lit", 97)] + [("match", 285, 0, 0, 0, 0, 0)] * 32
    for k in range(120):
        body += [("match", 257, 0, 0, 26 - k % 2, 12 - k % 2, (37 * k) % 64),
                 ("lit", (105, 106, 109)[k % 3])]
    return cs.craft_dynamic_stream(ll, of, body + [("eob",)])


def _stored_landing(land: int, head, tail, seed: int) -> bytes:
    """A Huffman block of the head tokens, a stored block whose data ends
    at byte land (where the next header starts), then a final block of the
    tail tokens."""
    bw = cs.BitWriter()
    cs.put_token_block(bw, head, False)
    start = (len(bw.out) * 8 + bw.n + 3 + 7) // 8 + 4
    data = np.random.default_rng(seed).integers(0, 256, land - start,
                                                np.uint8).tobytes()
    cs.put_stored(bw, data, False)
    cs.put_token_block(bw, tail)
    return bw.bytes()


def edges_set(text: bytes) -> list:
    rng = np.random.default_rng(13)
    lits = [("lit", int(v)) for v in rng.integers(0, 256, 300)]
    every = [("match", 258, d) for d in range(1, 41)]
    out = [("litlen and offset codes of R, R + 1 and 15 bits",
            _deep_literals()),
           ("length codes of R, R + 1 and 15 bits", _deep_lengths()),
           ("offsets of 25 and 27 bits, each before a long literal code",
            _far_offsets()),
           ("stored onto a segment edge, then distances 1-40 x 258",
            _stored_landing(2 * SEGMENT, lits, every, 1)),
           ("stored across two segments to one byte before an edge",
            _stored_landing(3 * SEGMENT - 1, lits, every[:20], 2)),
           ("stored to one byte past a segment edge",
            _stored_landing(SEGMENT + 1, lits[:40], every[::3], 3)),
           ("stored LEN 0, 1, 2, 3 in a row, then matches",
            cs.blocks_stream(("tokens", lits[:50]), ("stored", b""),
                             ("stored", b"x"), ("stored", b"yz"),
                             ("stored", b"abc"), ("tokens", every[:8]))),
           ("distances 1-40 x 258 right after a stored block",
            cs.blocks_stream(("stored", text[:100]), ("tokens", every)))]
    return [(name, s, len(s)) for name, s in out]


def sets(text: bytes) -> dict:
    """{set name: cases}."""
    return {"zlib": zlib_set(text), "damaged": damaged_set(text),
            "incomplete": incomplete_set(), "traps": trap_set(text),
            "edges": edges_set(text)}


def batches(cases):
    """The cases in batches of B rows: [(bufs uint8 [B, N], in_lens
    int32 [B], n real rows)], the last batch's spare rows empty."""
    out = []
    for i in range(0, len(cases), B):
        part = cases[i:i + B]
        bufs = np.zeros((B, N), np.uint8)
        lens = np.zeros(B, np.int32)
        for k, (_, s, n) in enumerate(part):
            s = s[:N]
            bufs[k, :len(s)] = np.frombuffer(s, np.uint8)
            lens[k] = n
        out.append((bufs, lens, len(part)))
    return out


def repack(bufs: np.ndarray, n: int = ODD_N) -> np.ndarray:
    """The batch's rows cut to their first n bytes, contiguous: row b
    starts b * n bytes into the buffer, so with n odd no row after the
    first starts on a 4-byte boundary."""
    return np.ascontiguousarray(bufs[:, :n])


def crafted_batches(text: bytes) -> dict:
    """K3's crafted sets (``crafted_streams.decode_sets``: distance 32768
    into the flushed half, items across 32 KiB boundaries, stored blocks
    longer than the ring, output past 81920 bytes, ...) as FSM batches
    decoded into ``crafted_streams.DEC_OUT_BYTES`` a row: {name: (bufs
    uint8 [DEC_B, 4 * W], in_lens int32 [DEC_B], n real rows)}."""
    out = {}
    for name, (streams, _, _) in cs.decode_sets(text).items():
        bufs = np.zeros((cs.DEC_B, 4 * cs.W), np.uint8)
        lens = np.zeros(cs.DEC_B, np.int32)
        for k, st in enumerate(streams):
            bufs[k, :len(st)] = np.frombuffer(st, np.uint8)
            lens[k] = len(st)
        out[name] = (bufs, lens, len(streams))
    return out


def pin_rows(out, out_lens, consumed, result, n: int) -> list:
    """[SHA-256 of the whole out row, out_len, consumed, result] of the
    first n rows of one batch's results (numpy arrays or tensors)."""
    out, out_lens, consumed, result = (np.asarray(x) for x in
                                       (out, out_lens, consumed, result))
    return [[hashlib.sha256(out[k].tobytes()).hexdigest(), int(out_lens[k]),
             int(consumed[k]), int(result[k])] for k in range(n)]
