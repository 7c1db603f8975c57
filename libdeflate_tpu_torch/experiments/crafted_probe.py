"""Crafted inputs for C5, the sorted matchfind's probes after the sort
(``compress/probe_kernels.py``), and a numpy mirror of the kernel's walk.

``probe_sets()[name]`` is (h, bp, seg, shift): the hash int64 [B, n] and
the padded bytes uint8 [B, n] of one batch, its segment and the payload
offset; ``RUNS`` names the (form, depth, payload width) each set runs at.
The hash is the input the kernel sorts, so the sets set it freely: most
is the real hash of the bytes (``pipeline._row_inputs``' arithmetic),
with the junk bucket past a row's live length, and crafted stretches
carry planted hashes.  The sets hold:

- text of a small vocabulary, where same-hash groups of every size cross
  the tiles' edges (64 and 256 sorted slots) and the halo;
- rows of one byte, whose every slot shares one hash, so that a
  segment's first ``depth`` slots see equal hashes before them only
  through the roll's wrap, which the gate ``j >= d`` cuts;
- the junk hash on equal bytes: 32767 at 128 KiB segments (a real hash
  value), 32768 at 64 KiB;
- pairs at distance 32768 (taken) and 32769 (not taken);
- 16-byte strings copied with their first unequal byte at 0 .. 15 and
  whole (LCP 0-3, 4, ..., 15 and 16 with ``fine`` 0);
- equal strings in a row's last bytes, whose payloads read the zeros
  past the row's end, with and without the rescue pass's half-segment
  offset;
- ties: three copies at equal (mlen, fine), where the nearest wins, and
  two at equal (mlen, fine) with another remainder below;
- short chunks, where the segment is the padded row itself (384 and 5120
  positions).

``mirror`` follows ``csrc/segment_probe.cu`` step by step: tiles of
``tile`` sorted slots a block, each loading its slots and the ``depth``
before it (never before the segment's start) into "shared" arrays (hash
and position from the key, the payload words by W + 1 aligned 32-bit
loads funnel-shifted to the byte, zero past the row), the probes from
there with the kernel's gate and word LCP, the best in one pass and the
runner-up in a second, each slot's outputs packed into one word (A's 23
bits, B's above them, C's 18 bits from bit 46) written at the slot's own
position, and the segment's words then unpacked in position order.
With ``stats`` (a Counter) it counts what the sets must reach: matches
whose neighbour is in the halo (``halo``), gated slots whose wrapped
neighbour shares the hash (``wrap``), equal-hash equal-payload slots in
the junk bucket (``junk_real``), matches at 32768 (``window``) and
would-be ones at 32769 (``window_plus``), each LCP in bytes
(``lcp_<k>``, 0-3 from the first word's XOR), payload loads past the
row's end behind a compared probe (``zero_fill``), equal (mlen, fine)
between two matches of one slot (``tie``), lean slots without a second
distance (``b_zero``) and with a match but none (``b_zero_match``),
and short rows (``short``).  The CPU tests hold the mirror and the plain
versions to each other and to the JAX package; ``chip_smoke.py`` holds
the kernel to the plain versions on the same sets.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

TILE = 256                      # the kernel's sorted slots a block
MIRROR_TILES = (64, TILE)
MAX_DEPTH = 32
WINDOW = 32768
INVD = WINDOW + 1
N64, N128 = 1 << 16, 1 << 17
MULT = 0x1E35A7BD
HASH_ORDER = 15
# (form, depth, payload bytes) of every caller the kernel serves: the
# static tier, dyn1, the rescue pass, lean and its 8-byte option, and a
# depth of one (no second distance at all)
RUNS = (("best", 2, 16), ("best", 6, 16), ("best", 2, 8), ("lean", 6, 16),
        ("lean", 6, 8), ("lean", 1, 16))
SET_NAMES = ("text, 128 KiB", "text, 64 KiB", "one byte, one hash",
             "planted, 128 KiB", "planted, 128 KiB, half a segment on",
             "planted, 64 KiB", "planted, 64 KiB, half a segment on",
             "short, n_pad 384", "short, n_pad 5120")


def key_params(seg: int) -> tuple[int, int]:
    """(pos_bits, junk) of a segment (``bits.seg_key_params``)."""
    pos_bits = max(16, (seg - 1).bit_length())
    return pos_bits, (1 << HASH_ORDER) - 1 if pos_bits >= 17 \
        else 1 << HASH_ORDER


def real_hash(bp: np.ndarray, lengths, seg: int) -> np.ndarray:
    """The parsers' hash of ``bp`` [B, n]: the le32 word at each byte
    times MULT, top 15 bits, junk where fewer than 4 live bytes remain."""
    B, n = bp.shape
    b = np.concatenate([bp, np.zeros((B, 3), np.uint8)], 1).astype(np.int64)
    w = b[:, :n] | b[:, 1:n + 1] << 8 | b[:, 2:n + 2] << 16 \
        | b[:, 3:n + 3] << 24
    h = ((w * MULT) & 0xFFFFFFFF) >> (32 - HASH_ORDER)
    live = np.arange(n)[None] + 4 <= np.asarray(lengths)[:, None]
    return np.where(live, h, key_params(seg)[1])


def _bytes(rng, k: int, lo: int = 0, hi: int = 256) -> bytes:
    return rng.integers(lo, hi, k).astype(np.uint8).tobytes()


def _text(rng, n: int) -> np.ndarray:
    words = [_bytes(rng, rng.integers(2, 9), 97, 123) for _ in range(60)]
    out = bytearray()
    while len(out) < n:
        out += words[rng.integers(0, len(words))] + b" "
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _plant(bp, h, at, s: bytes, hval: int) -> None:
    """Bytes ``s`` at (row, position) ``at`` under the hash ``hval``."""
    r, p = at
    bp[r, p:p + len(s)] = np.frombuffer(s, np.uint8)
    h[r, p] = hval


def probe_sets() -> dict:
    """name -> (h int64 [B, n], bp uint8 [B, n], seg, shift)."""
    rng = np.random.default_rng(27)
    sets = {}
    # text over one 128 KiB segment a row, and over two of 64 KiB
    bp = np.stack([_text(rng, N128), _text(rng, N128)])
    lengths = [N128, N128 - 3000]
    sets["text, 128 KiB"] = (real_hash(bp, lengths, N128), bp, N128, 0)
    bp = np.stack([_text(rng, N128), _text(rng, N128)])
    lengths = [N128, N128 - 777]
    sets["text, 64 KiB"] = (real_hash(bp, lengths, N64), bp, N64, 0)
    # one byte a row: every slot of a segment shares one hash
    bp = np.full((2, N128), ord("a"), np.uint8)
    bp[1] = ord("b")
    sets["one byte, one hash"] = (real_hash(bp, [N128, N128 - 40], N64), bp,
                                  N64, 0)
    # random bytes with planted strings under planted hashes
    for seg in (N128, N64):
        bp = rng.integers(0, 256, (2, N128)).astype(np.uint8)
        h = real_hash(bp, [N128, N128], seg)
        junk = key_params(seg)[1]
        s16 = _bytes(rng, 16)
        # the junk bucket over equal bytes: a run of copies
        for k in range(40):
            _plant(bp, h, (0, 1000 + 20 * k), s16, junk)
        # the window's edge: 32768 taken, 32769 not
        _plant(bp, h, (0, 5000), s16, 11)
        _plant(bp, h, (0, 5000 + WINDOW), s16, 11)
        _plant(bp, h, (1, 7000), s16, 12)
        _plant(bp, h, (1, 7000 + WINDOW + 1), s16, 12)
        # the LCP ladder: the copy's first unequal byte at k, or none
        for k in range(17):
            base = _bytes(rng, 16)
            copy = bytearray(base)
            if k < 16:
                copy[k] ^= 0x5A
            p = 50000 + 300 * k
            _plant(bp, h, (0, p), base, 100 + k)
            _plant(bp, h, (0, p + 100 + 7 * k), bytes(copy), 100 + k)
        # ties: three whole copies (mlen 16 twice at the third); and
        # two copies unequal at byte 10 under a third (8, 2 twice)
        t = _bytes(rng, 16)
        for k in range(3):
            _plant(bp, h, (1, 60000 + 100 * k), t, 200)
        u = bytearray(t)
        u[10] ^= 1
        v = bytearray(t)
        v[10] ^= 2
        _plant(bp, h, (1, 61000), t, 201)
        _plant(bp, h, (1, 61100), bytes(u), 201)
        _plant(bp, h, (1, 61300), bytes(v), 201)
        # the row's end: six bytes then the zeros past it
        tail = _bytes(rng, 6, 1)
        n = bp.shape[1]
        _plant(bp, h, (0, n - 6), tail, 300)
        _plant(bp, h, (0, n - 56), tail + bytes(10), 300)
        sets[f"planted, {seg // 1024} KiB"] = (h, bp, seg, 0)
        # the rescue pass: the hash shifted half a segment, the bytes not
        half = seg // 2
        hs = np.concatenate([h[:, half:], np.full((2, half), junk)], 1)
        sets[f"planted, {seg // 1024} KiB, half a segment on"] = (
            hs, bp, seg, half)
    # short chunks: the segment is the padded row
    for n, live in ((384, (300, 384)), (5120, (5000, 4321))):
        bp = np.stack([_text(rng, n), _text(rng, n)])
        bp[:, live[0]:] = 0
        sets[f"short, n_pad {n}"] = (real_hash(bp, live, n), bp, n, 0)
    return sets


def mirror(h, bp, seg: int, depth: int, width: int, form: str,
           shift: int = 0, tile: int = TILE, stats=None):
    """C5 on numpy: "best" -> (mlen, dist, fine), "lean" -> the (A, B, C)
    triples, each int64 [B, n], from the kernel's walk (module doc)."""
    h = np.asarray(h, np.int64)
    bp = np.asarray(bp, np.uint8)
    B, n = h.shape
    W = width // 4
    rows, per_row = h.size // seg, n // seg
    pos_bits, junk = key_params(seg)
    mask = (1 << pos_bits) - 1
    keys = np.sort((h.reshape(rows, seg) << pos_bits) | np.arange(seg), 1)
    count = stats if stats is not None else Counter()
    count["short"] += int(seg == n and n < N64)
    # the bytes as aligned little-endian words, one more past the end
    words = np.concatenate([bp.view("<u4").astype(np.uint64),
                            np.zeros((B, W + 1), np.uint64)], 1)
    tiles = -(-seg // tile)
    T, L = tile, tile + depth
    # every block's "shared" slots: [rows, tiles, L], slot t*T - depth + i
    slot = (np.arange(tiles) * T)[:, None] - depth + np.arange(L)[None]
    loaded = (slot >= 0) & (slot < seg)
    k = keys[:, np.clip(slot, 0, seg - 1)]
    s_hash = np.where(loaded, k >> pos_bits, -1)
    s_pos = np.where(loaded, k & mask, -1)
    q = (np.arange(rows) % per_row * seg + shift)[:, None, None] + s_pos
    brow = (np.arange(rows) // per_row)[:, None, None]
    w0, sh = q >> 2, ((q & 3) * 8).astype(np.uint64)
    past = w0[..., None] + np.arange(W + 1) >= n // 4
    w = words[brow[..., None], np.clip(w0[..., None] + np.arange(W + 1), 0,
                                       words.shape[1] - 1)]
    w = np.where(past, 0, w)
    s_pay = ((w[..., 1:] << np.uint64(32) | w[..., :-1])
             >> sh[..., None]) & np.uint64(0xFFFFFFFF)
    # the block's own slots
    j = slot[:, depth:]
    oh, op, opay = s_hash[:, :, depth:], s_pos[:, :, depth:], \
        s_pay[:, :, depth:]
    own = np.broadcast_to((j < seg)[None], oh.shape)
    opast = past[:, :, depth:].any(-1)
    live = own & (oh != junk)

    def probe(d):
        """The packed probe of slot j - d, and its eq4."""
        nh, npos = s_hash[:, :, depth - d:L - d], s_pos[:, :, depth - d:L - d]
        npay = s_pay[:, :, depth - d:L - d]
        gate = live & (j >= d)[None]
        same = gate & (nh == oh)
        assert not (same & (nh < 0)).any(), "read a slot not loaded"
        dist = op - npos
        ok = same & (dist <= WINDOW)
        x = opay ^ npay
        eq4 = ok & (x[..., 0] == 0)
        mlen = np.full(oh.shape, 4, np.int64)
        first = np.zeros(oh.shape, np.uint64)
        for e in range(1, W):
            xe = x[..., e]
            mlen += np.where((first == 0) & (xe == 0), 4, 0)
            first = np.where((first == 0) & (xe != 0), xe, first)
        low = (first & (~first + np.uint64(1))).astype(np.float64)
        fine = np.where(first != 0, np.log2(np.maximum(low, 1)).astype(
            np.int64) >> 3, 0)
        p = np.where(eq4, mlen << 18 | fine << 16 | (INVD - dist), INVD)
        if stats is not None:
            count["halo"] += int((eq4 & (np.arange(T) < d)[None, None]).sum())
            count["window"] += int((eq4 & (dist == WINDOW)).sum())
            count["window_plus"] += int((same & (dist == WINDOW + 1)
                                         & (x[..., 0] == 0)).sum())
            x0 = x[..., 0]
            low0 = (x0 & (~x0 + np.uint64(1))).astype(np.float64)
            tz0 = np.log2(np.maximum(low0, 1)).astype(np.int64) >> 3
            lcp = np.where(eq4, mlen + fine, np.where(ok, tz0, -1))
            for b, c in enumerate(np.bincount(lcp[lcp >= 0], minlength=17)):
                count[f"lcp_{b}"] += int(c)
            npast = past[:, :, depth - d:L - d].any(-1)
            count["zero_fill"] += int((same & (opast | npast)).sum())
            wrap_h = keys[:, (seg + np.clip(j, 0, seg - 1) - d) % seg] \
                >> pos_bits
            count["wrap"] += int((own & (oh != junk) & (j < d)[None]
                                  & (wrap_h == oh)).sum())
            count["junk_real"] += int((own & (j >= d)[None] & (oh == junk)
                                       & (nh == oh) & (x[..., 0] == 0)
                                       ).sum())
        return p, eq4

    probes = [probe(d) for d in range(1, depth + 1)]
    a = np.zeros(oh.shape, np.int64)
    for p, _ in probes:
        a = np.maximum(a, p)
    if stats is not None:
        pf = [np.where(e, p >> 16, -1) for p, e in probes]
        for x in range(len(pf)):
            for y in range(x + 1, len(pf)):
                count["tie"] += int(((pf[x] == pf[y]) & (pf[x] >= 0)).sum())

    def pay(p):
        """A packed probe as mlen << 18 | fine << 16 | dist (23 bits)."""
        return (p & ~0xFFFF) | ((INVD - (p & 0xFFFF)) & 0xFFFF)

    word = pay(a)
    if form == "lean":
        b = np.zeros_like(a)
        for p, _ in probes:           # the second pass
            b = np.maximum(b, np.where((p & 0xFFFF) != (a & 0xFFFF), p, 0))
        c = probes[0][0]
        word = (word.astype(np.uint64)
                | np.where(b != 0, pay(b), 0).astype(np.uint64) << 23
                | (np.minimum(c >> 20, 3) << 16
                   | ((INVD - (c & 0xFFFF)) & 0xFFFF)).astype(np.uint64)
                << 46)
        if stats is not None:
            count["b_zero"] += int((own & (b == 0)).sum())
            count["b_zero_match"] += int((own & (b == 0)
                                          & (a >> 18 > 0)).sum())
    # each own slot's packed word at its position, then the segment
    # unpacked in position order
    packed = np.zeros(h.size, np.uint64)
    packed[(np.arange(rows)[:, None, None] * seg + op)[own]] = word[own]

    def unpay(v):
        v = (v & np.uint64(0x7FFFFF)).astype(np.int64)
        return tuple(x.reshape(B, n) for x in (v >> 18, v & 0xFFFF,
                                               (v >> 16) & 3))

    if form == "best":
        return unpay(packed)
    cw = (packed >> np.uint64(46)).astype(np.int64)
    return (unpay(packed), unpay(packed >> np.uint64(23)),
            tuple(x.reshape(B, n) for x in ((cw >> 16) << 2, cw & 0xFFFF,
                                            np.zeros_like(cw))))
