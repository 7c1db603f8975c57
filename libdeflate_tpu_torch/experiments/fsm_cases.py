"""The FSM decoder's cases: streams, their batches and the pins.

``tests/test_torch_fsm.py`` holds the plain FSM decoder
(``decompress/fsm.py``) to the JAX package's ``decompress/tpu.py`` on these
sets, ``tests/pin_fsm.py`` pins the JAX decoder's 4-tuples of the pinned
sets into ``fsm_pins.json``, and ``chip_smoke.py`` holds the kernel (F1)
to its plain version and to the pins on the card.  Every set is decoded in
batches of B = 8 rows of N = 8192 bytes into OUT = 16384 bytes a row, the
shape of ``tests/test_tpu_decode.py``, so that the JAX decoder compiles
once.  A case is (name, stream, in_len): the stream's first N bytes go in
its row, and in_len may differ from its length.

- ``zlib_set``: zlib levels 0, 1, 6 and 9, Z_FIXED, Z_HUFFMAN_ONLY and
  Z_RLE of repository text, and level 6 of random bytes;
- ``damaged_set``: like ``chip_smoke.damaged_streams``, eight zlib-6
  streams (every fourth Z_FIXED) each with 1-3 bit flips, a byte
  overwritten, a cut in the middle and a cut of 1-3 bytes at the end;
- ``incomplete_set``: the zlib-lax incomplete codes
  (``crafted_streams.incomplete_codes`` and the streams of
  ``tests/test_incomplete_codes.py``), and the shapes that are rejected;
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
PINNED_SETS = ("damaged", "incomplete", "traps")
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


def sets(text: bytes) -> dict:
    """{set name: cases}."""
    return {"zlib": zlib_set(text), "damaged": damaged_set(text),
            "incomplete": incomplete_set(), "traps": trap_set(text)}


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


def pin_rows(out, out_lens, consumed, result, n: int) -> list:
    """[SHA-256 of the whole out row, out_len, consumed, result] of the
    first n rows of one batch's results (numpy arrays or tensors)."""
    out, out_lens, consumed, result = (np.asarray(x) for x in
                                       (out, out_lens, consumed, result))
    return [[hashlib.sha256(out[k].tobytes()).hexdigest(), int(out_lens[k]),
             int(consumed[k]), int(result[k])] for k in range(n)]
