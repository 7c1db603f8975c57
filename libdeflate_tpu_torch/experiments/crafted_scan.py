"""Crafted inputs for C1, the commit FSM (``scan_kernels.commit_fsm``),
and C2, the code-length build (``scan_kernels.code_lens``): the segments
and histograms whose edges those loops must get exactly right.

The CPU tests hold numpy mirrors of both kernels' algorithms and the
plain versions against the JAX package's ``_greedy_commit_merge`` and
``_build_code_lens`` on these sets (``tests/test_torch_scan_kernels.py``),
and ``chip_smoke.py`` holds each CUDA kernel against its plain version on
the same sets.

``commit_sets()[name] = (span, is_match, dist)``: int64, bool and int64
arrays of shape [COMMIT_B, COMMIT_N], each run at every segment length in
``COMMIT_SEGS`` (the greedy tiers' 512 and the DP tiers' 1024).  Items are
laid out to tile each segment, so that the FSM commits where a case puts
its items; the positions an item covers hold noise the FSM must skip.
``commit_long_sets()[name] = (span, is_match, dist, seg)`` lays the same
kinds of items out for longer segments (``COMMIT_LONG``): 2600 positions,
not a multiple of C1's 64-position window, and 4608 = 9 x 512, so that
jumps, runs at the 258 cap, literal runs and matches truncated at the
segment end cross the kernel's window boundaries.

- same-distance chains whose budgets sum to 258 exactly, to 259 and past
  it (the cap splits the run), and chains that run to a segment's end;
- a match at each of the last three positions of a segment (truncated to
  1 and 2 bytes it becomes a literal, to 3 it stays a match), and one
  that crosses into the next segment;
- all-literal segments (is_match false, or every span below 3);
- is_match with dist 0, alone and in chains (a run needs pdist > 0);
- spans of 0, negative spans and spans far past 258 with is_match;
- random items over a few distances, so that many chains merge.

``hist_sets()[name]`` is an int64 [rows, 286] array of litlen-sized
histograms (a distance row is zero-padded, as ``build_code_lens_pair``
pads it), each run at every (refine_passes, max_len) in ``CODE_LENS_CFGS``.
``soak_payload(rng, kind, n)`` makes the five payload classes of
``scripts/tpu_soak.py``'s ``gen_payload`` (random, periodic, zeros,
words, a ten-letter alphabet), the port's own copy: ``chip_smoke.py``
commits random-length chunks of them through the lean and dyn1 entries,
and ``experiments/soak.py`` draws its payloads with it.
``hist_sets_other()`` holds rows of other widths: 30 symbols (a distance
row, unpadded) and 512 (the kernel's cap), and nine 286-symbol rows (more
rows than C2's four-row blocks, the last block partial).

``code_lens_mirror`` is C2's algorithm on one numpy row, step by step as
``csrc/code_lens.cu``'s warp takes it, counting the branches and steps it
takes; the CPU tests hold it to the JAX package, and ``code_lens_chain``
reads C2's dependent chain from its counts for ``chip_smoke.py``'s bound.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

COMMIT_B, COMMIT_N = 2, 4096
COMMIT_SEGS = (512, 1024)
COMMIT_LONG = ((2600, 5200), (4608, 9216))    # (seg, n) of a row
NSYM, NDIST = 286, 30
CODE_LENS_CFGS = ((0, 11), (16, 15))    # (refine_passes, max_len)


def _lay(items, seg: int, n: int, rng) -> tuple:
    """One row: noise everywhere, then each (t, span, is_match, dist) item
    written at its position."""
    span = rng.integers(-5, 400, n)
    is_match = rng.random(n) < 0.5
    dist = rng.integers(0, 40, n)
    for t, sp, im, d in items:
        span[t], is_match[t], dist[t] = sp, im, d
    return span, is_match, dist


def _tile(rng, seg: int, n: int, item_fn):
    """Items laid end to end from every segment start: item_fn(rng, t,
    room) gives (span, is_match, dist, advance) at position t with room
    positions left in its segment; the next item starts advance later."""
    items = []
    for s0 in range(0, n, seg):
        t = s0
        while t < s0 + seg:
            sp, im, d, adv = item_fn(rng, t, s0 + seg - t)
            items.append((t, sp, im, d))
            t += max(1, min(adv, s0 + seg - t))
    return items


def _chains(rng, t, room):
    """Runs of one distance whose budgets sum to 258, 259 or more."""
    pick = rng.integers(0, 6)
    if pick == 0:                       # 129 + 129 = 258: one run
        sp = 129
    elif pick == 1:                     # 130 + 129 = 259: split
        sp = 130
    elif pick == 2:
        sp = int(rng.integers(3, 40))
    elif pick == 3:                     # 258 alone, then more of its dist
        sp = 258
    elif pick == 4:                     # a literal breaks the run
        return 1, False, 0, 1
    else:
        sp = int(rng.integers(40, 120))
    d = 7 if rng.random() < 0.8 else 300
    return sp, True, d, min(sp, room)


def _to_the_end(rng, t, room):
    """Short same-distance items that run to the segment's end."""
    sp = int(rng.integers(3, 9))
    return sp, True, 5, min(sp, room)


def _dist0(rng, t, room):
    """Matches with distance 0 (and a few of 1), in chains."""
    sp = int(rng.integers(3, 30))
    return sp, True, 0 if rng.random() < 0.7 else 1, min(sp, room)


def _odd_spans(rng, t, room):
    """is_match with spans of 0, negative, far past 258, or 1-2."""
    sp = int(rng.choice([0, -1, -300, 1, 2, 259, 1000, 100000, 3, 17]))
    adv = sp if 3 <= sp <= room else (room if sp > room else 1)
    return sp, True, int(rng.integers(1, 4)), adv


def _random_items(rng, t, room):
    sp = int(rng.integers(1, 300))
    im = rng.random() < 0.7
    d = int(rng.choice([1, 2, 7, 300]))
    return sp, im, d, sp if im and min(sp, room) >= 3 else 1


def _seg_ends(seg: int, n: int, rng):
    """Literals up to the last few positions of each segment, then a match
    of 10 at seg-1, seg-2 or seg-3 (truncated to 1, 2 or 3), and one
    across the boundary with the next segment's first item."""
    items = []
    for k, s0 in enumerate(range(0, n, seg)):
        end = s0 + seg
        back = 1 + k % 3
        for t in range(s0, end - back):
            items.append((t, 1, False, 0))
        items.append((end - back, 10 + k, True, 9))
    return items


def commit_sets() -> dict:
    """name -> (span int64, is_match bool, dist int64), [2, 4096] each:
    the items are laid out for segments of 512 (every 1024-position
    segment is two of them, so the 512 layout's chain ends fall inside
    the longer segments and their runs continue or truncate there)."""
    out = {}
    makers = {
        "same-distance chains about the 258 cap":
            lambda rng: _tile(rng, 512, COMMIT_N, _chains),
        "same-distance chains to the segment end":
            lambda rng: _tile(rng, 512, COMMIT_N, _to_the_end),
        "matches truncated at the segment end":
            lambda rng: _seg_ends(512, COMMIT_N, rng),
        "is_match with dist 0":
            lambda rng: _tile(rng, 512, COMMIT_N, _dist0),
        "spans 0, negative, past 258":
            lambda rng: _tile(rng, 512, COMMIT_N, _odd_spans),
        "random items over four distances":
            lambda rng: _tile(rng, 512, COMMIT_N, _random_items),
    }
    for seed, (name, make) in enumerate(makers.items()):
        rng = np.random.default_rng(100 + seed)
        rows = [_lay(make(rng), 512, COMMIT_N, rng) for _ in range(COMMIT_B)]
        out[name] = tuple(np.stack([r[i] for r in rows]) for i in range(3))
    rng = np.random.default_rng(99)
    span = rng.integers(1, 300, (COMMIT_B, COMMIT_N))
    out["all literal: is_match false"] = (
        span, np.zeros((COMMIT_B, COMMIT_N), bool),
        rng.integers(1, 9, (COMMIT_B, COMMIT_N)))
    out["all literal: spans below 3"] = (
        rng.integers(-2, 3, (COMMIT_B, COMMIT_N)),
        np.ones((COMMIT_B, COMMIT_N), bool),
        np.full((COMMIT_B, COMMIT_N), 4))
    return {k: (s.astype(np.int64), m.astype(bool), d.astype(np.int64))
            for k, (s, m, d) in out.items()}


def _long_seg_ends(seg: int, n: int, rng):
    """Literals, then near each segment's end a 40-byte match and, after
    it, a match of the same distance that starts in the window before the
    last one and is truncated at the segment end (a cut across a window
    boundary); every other segment has an is_match of span 2 there
    instead (a literal)."""
    items = []
    w = 64
    for k, s0 in enumerate(range(0, n, seg)):
        end = s0 + seg
        last_w = s0 + (seg - 1) // w * w      # the last window's start
        start = last_w - 10 - 7 * k
        for t in range(s0, start - 40):
            items.append((t, 1, False, 0))
        items.append((start - 40, 40, True, 6))
        items.append((start, 400 if k % 2 == 0 else 2, True, 6))
    return items


def commit_long_sets() -> dict:
    """name -> (span int64, is_match bool, dist int64, seg), [2, n] each
    for every (seg, n) in COMMIT_LONG."""
    out = {}
    makers = {
        "same-distance chains about the 258 cap":
            lambda rng, seg, n: _tile(rng, seg, n, _chains),
        "random items over four distances":
            lambda rng, seg, n: _tile(rng, seg, n, _random_items),
        "spans 0, negative, past 258":
            lambda rng, seg, n: _tile(rng, seg, n, _odd_spans),
        "matches truncated at the segment end":
            lambda rng, seg, n: _long_seg_ends(seg, n, rng),
    }
    for seg, n in COMMIT_LONG:
        for seed, (name, make) in enumerate(makers.items()):
            rng = np.random.default_rng(200 + seed + seg)
            rows = [_lay(make(rng, seg, n), seg, n, rng)
                    for _ in range(COMMIT_B)]
            out[f"{name}, seg {seg}"] = tuple(
                np.stack([r[i] for r in rows]) for i in range(3)) + (seg,)
    return {k: (s.astype(np.int64), m.astype(bool), d.astype(np.int64), g)
            for k, (s, m, d, g) in out.items()}


def _row(pairs) -> np.ndarray:
    h = np.zeros(NSYM, np.int64)
    for i, c in pairs:
        h[i] = c
    return h


def hist_sets() -> dict:
    """name -> int64 [rows, 286] histograms."""
    rng = np.random.default_rng(7)
    ar = np.arange(NSYM)
    sets = {
        "two used symbols": np.stack([
            _row([(3, 1000), (200, 1)]), _row([(0, 1), (285, 1)]),
            _row([(256, 5), (1, 5)]), _row([(10, 1 << 20), (11, 1)])]),
        "one dominant symbol": np.stack([
            _row([(65, 1 << 20)] + [(i, 1) for i in range(100, 140)]),
            _row([(256, 1)] + [(0, 900000)] + [(i, 3) for i in (7, 9)]),
            _row([(i, 1) for i in range(NSYM)] + [(40, (1 << 20) - 285)])]),
        "all 286 used": np.stack([
            rng.integers(1, 5000, NSYM), rng.integers(1, 3, NSYM),
            rng.multinomial((1 << 20) - NSYM, rng.dirichlet(
                np.full(NSYM, 0.05))) + 1]),
        "equal counts": np.stack([
            np.full(NSYM, 7), np.where(ar < 30, 1000, 0),
            np.where(ar % 3 == 0, 12, 0), np.where(ar < 129, 1, 0)]),
        # most of the mass on a few symbols: the rest have share 0 and
        # bump to k = 2
        "zero-share symbols": np.stack([
            _row([(0, 400000), (1, 300000)] + [(i, 1) for i in range(2, 60)]),
            _row([(i, 1 << 17) for i in range(8)]
                 + [(i, 2) for i in range(8, NSYM)])]),
        "totals near 2^20": np.stack([
            rng.multinomial((1 << 20) - 1, rng.dirichlet(np.full(NSYM, 0.3))),
            rng.multinomial(1 << 20, rng.dirichlet(np.full(NSYM, 3.0))),
            rng.multinomial((1 << 20) + 1,
                            rng.dirichlet(np.full(NSYM, 0.02)))]),
        # halving counts force the longest codes, past 11 bits
        "geometric": np.stack([
            (1 << np.clip(20 - ar, 0, 20)) * (ar < 40),
            (3 << np.clip(18 - ar // 2, 0, 18)) * (ar < 60)]),
        "ties at every level": np.stack([
            np.random.default_rng(28).choice(
                [1, 2, 3, 5, 6, 12, 24, 100, 300], NSYM),
            np.random.default_rng(29).choice([0, 1, 1, 2, 4, 4, 8], NSYM)]),
        # distance-sized rows, zero-padded to 286 as build_code_lens_pair
        # pads them, and rows with no or one used symbol (ok False)
        "distance rows and degenerate rows": np.stack([
            np.where(ar < NDIST, rng.integers(0, 9000, NSYM), 0),
            np.where(ar < NDIST, 1, 0), np.zeros(NSYM, np.int64),
            _row([(17, 12345)]), _row([(0, 1)])]),
    }
    # counts of 2^21 and more: the kernel sorts 64-bit keys (the JAX
    # package's int32 keys hist * 512 + nsym - i hold them below 2^22)
    sets["counts past 2^21"] = np.stack([
        rng.integers(1 << 21, 1 << 22, NSYM),
        _row([(5, (1 << 22) - 1), (6, 1 << 21), (7, 3)]
             + [(i, 1) for i in range(100, 160)]),
        np.where(ar % 7 == 0, (1 << 21) + ar, np.where(ar % 7 == 1, 2, 0))])
    # the fix's halving branch: with every k a power of two, r > 0 is a
    # multiple of the smallest k, so some k <= r can double unless every
    # k is kraft / 2; then at most one symbol is used and the halving set
    # is empty too.  So the branch runs only on index 0, as an empty set:
    # one used symbol at index 0 halves and doubles through all 48 steps,
    # one elsewhere halves k[0] = 0 (a fixed point at once)
    sets["fix: halving an empty set"] = np.stack([
        _row([(0, 5)]), _row([(0, 1 << 20)]), _row([(285, 7)]),
        _row([(1, 2)])])
    return {k: np.asarray(v, np.int64) for k, v in sets.items()}


def hist_sets_other() -> dict:
    """name -> int64 [rows, nsym] histograms of other shapes than
    hist_sets': 30 and 512 symbols, and nine rows of 286."""
    rng = np.random.default_rng(8)
    a30, a512 = np.arange(NDIST), np.arange(512)
    sets = {
        "30 symbols (a distance row)": np.stack([
            rng.integers(0, 9000, NDIST), np.where(a30 < 2, 3, 0),
            (1 << np.clip(20 - a30, 0, 20)), np.full(NDIST, 5),
            np.where(a30 == 29, 7, 0)]),
        "512 symbols (the cap)": np.stack([
            rng.integers(1, 4000, 512),
            rng.multinomial((1 << 20) - 512, rng.dirichlet(
                np.full(512, 0.05))) + 1,
            np.where(a512 % 5 == 0, 11, 0),
            np.where(a512 >= 500, rng.integers(1, 50, 512), 0),
            np.where(a512 == 0, 9, np.where(a512 == 511, 3, 0))]),
        "nine rows": np.stack(
            [rng.multinomial(1 << 16, rng.dirichlet(np.full(NSYM, x)))
             for x in (0.02, 0.05, 0.1, 0.3, 1.0, 3.0)]
            + [np.where(np.arange(NSYM) < 40, 1 << 10, 0),
               _row([(3, 5), (9, 5)]), np.zeros(NSYM, np.int64)]),
    }
    return {k: np.asarray(v, np.int64) for k, v in sets.items()}


SOAK_WORDS = (b"alpha", b"bravo", b"charlie", b" ", b"\n", b"the", b"qux")


def soak_payload(rng, kind: int, n: int) -> bytes:
    """n bytes of payload class kind (0-4), drawn from rng as
    ``scripts/tpu_soak.py::gen_payload`` draws them."""
    if kind == 0:
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == 1:
        period = int(rng.integers(1, 500))
        return (rng.integers(0, 256, period, np.uint8).tobytes()
                * (n // period + 1))[:n]
    if kind == 2:
        return bytes(n)
    if kind == 3:
        out = bytearray()
        while len(out) < n:
            out += SOAK_WORDS[int(rng.integers(0, len(SOAK_WORDS)))]
        return bytes(out[:n])
    return rng.integers(97, 107, n, np.uint8).tobytes()


# ---- C2's algorithm on numpy --------------------------------------------

REDUCE_LEVELS = 5   # a reduction across a warp's 32 lanes: log2(32) levels


def bsr(x: int) -> int:
    return int(x).bit_length() - 1


def code_lens_mirror(hist, refine_passes, max_len, seen=None):
    """csrc/code_lens.cu's warp on one numpy row: (lens, ok).  ``seen``
    (a Counter) counts the branches and steps taken: a "spend clamp" a
    clamp, "double", "halve" or "halve an empty set" a fix step, "refine
    move" or "refine fixed point" a refinement pass, a "level step" each
    level step that runs."""
    seen = Counter() if seen is None else seen
    h = np.asarray(hist, np.int64)
    nsym = h.size
    used = h > 0
    kraft = 1 << max_len
    n_used = int(used.sum())
    total = max(int(h.sum()), 1)
    scale = np.float32(kraft) / np.float32(total)

    def seed(hh):
        """k_des of counts: the seed's two correctly rounded f32
        operations, the bump (share 0 wraps and bumps)."""
        share = (hh.astype(np.float32) * scale).astype(np.uint32)
        out = np.zeros(hh.size, np.int64)
        for s, sh in enumerate(share.tolist()):
            e = bsr(max(sh, 1))
            if (sh - (1 << e)) & 0xFFFFFFFF > 1 << max(e - 1, 0):
                e += 1
                seen["bump" if sh else "bump of share 0"] += 1
            out[s] = 1 << min(max(e, 0), max_len - 1)
        return out

    # the used symbols compacted and sorted descending by hist << 10 |
    # 1023 - i (the bitonic network's result: the keys are unique) into
    # N = 32 J slots, J consecutive positions a lane
    sym = np.flatnonzero(used)
    keys = np.sort((h[sym] << 10) | (1023 - sym))[::-1]
    N = max(32, 1 << max(n_used - 1, 0).bit_length())
    assert N // 32 in (1, 2, 4, 8, 16) and n_used <= N
    hs, sym = keys >> 10, 1023 - (keys & 1023)
    p = np.arange(n_used)
    kd = seed(hs)

    # the spend: s under "no clamp" by a scan, then the clamps in order
    s0 = kraft - (n_used - 1)
    su = s0 + np.concatenate([[0], np.cumsum(1 - kd)[:-1]]).astype(np.int64)
    if s0 > 1:
        f = -1
        while True:
            fail = np.flatnonzero((p > f) & (su < kd))
            if not fail.size:
                break
            f = int(fail[0])
            sf = int(su[f])
            assert 1 <= sf < kd[f]
            kf = 1 << bsr(sf)
            su[f + 1:] += kd[f] - kf
            seen["spend clamp"] += 1
            if sf + 1 - kf <= 1:
                seen["spend at s = 1"] += 1
                break
    else:
        seen["spend at s = 1"] += 1
    k = np.array([1 << bsr(min(int(a), max(int(b), 1)))
                  for a, b in zip(kd, su)], np.int64)

    # the fix steps, 32-bit keys k << 9 | index
    r = kraft - int(k.sum())
    for _ in range(48):
        if r <= 0:
            break
        dbl = (k <= r) & (k < (kraft >> 1))
        dkey = int(((k << 9) | (511 - sym))[dbl].max()) if dbl.any() else 0
        if dkey:
            idx, delta = 511 - (dkey & 511), dkey >> 9
            seen["double"] += 1
        else:
            hlv = (k > r) & (k >= 2)
            if hlv.any():
                hkey = int(((k << 9) | sym)[hlv].min())
                idx, kidx = hkey & 511, hkey >> 9
                seen["halve"] += 1
            else:
                idx, kidx = 0, int(k[sym == 0].sum())
                seen["halve an empty set"] += 1
            delta = -(kidx >> 1)
        if delta == 0:
            seen["fix fixed point"] += 1
            break
        k[sym == idx] += delta
        r -= delta
    lens = max_len - np.array([bsr(x) for x in k], np.int64)

    # the refinement over sorted positions p and p2 (hist descending,
    # index descending: the level steps' least frequent symbol of a length
    # is its largest p2)
    if refine_passes:
        start = np.r_[True, hs[1:] != hs[:-1]]
        g0 = np.maximum.accumulate(np.where(start, p, -1))
        end = np.r_[hs[:-1] != hs[1:], True]
        g1 = np.minimum.accumulate(np.where(end, p, N)[::-1])[::-1]
        p2 = g0 + g1 - p
        p_of_p2 = np.empty(n_used, np.int64)
        p_of_p2[p2] = p
        assert np.array_equal(p_of_p2, np.lexsort((-sym, -hs)))
        hs2 = hs[p_of_p2]
        present = set(lens.tolist())       # never changes: moves swap
        lens_b = np.empty(n_used, np.int64)
        lens_b[p2] = lens
    for _ in range(refine_passes):
        amin, bmax = {}, {}
        for ln in present:             # the ballots: first and last lane
            amin[ln] = int(p[lens == ln].min())
            bmax[ln] = int(p[lens_b == ln].max())
        moved, bsel = set(), {}
        mprev, bprev, hprev = False, None, 0
        for ln in range(2, max_len + 1):
            mv = False
            if ln in present and ln - 1 in present:
                seen["level step"] += 1
                b = bmax[ln - 1]
                hb = int(hs2[b])
                if mprev and bprev > b:
                    b, hb = bprev, hprev
                    seen["B carried from the step before"] += 1
                mv = int(hs[amin[ln]]) > hb
                bsel[ln], bprev, hprev = b, b, hb
            else:
                seen["skipped level"] += 1
            mprev = mv
            if mv:
                moved.add(ln)
        if not moved:
            seen["refine fixed point"] += 1
            break
        seen["refine move"] += 1
        up = np.zeros(n_used, np.int64)
        for ln in moved:                # lane ln's atomics
            lens[amin[ln]] -= 1
            lens_b[p2[amin[ln]]] -= 1
            lens_b[bsel[ln]] += 1
            lens[p_of_p2[bsel[ln]]] += 1
            up[bsel[ln]] += 1
        if (up > 1).any():
            seen["up through two levels"] += 1
    out = np.zeros(nsym, np.int64)
    out[sym] = lens
    return out, r == 0 and n_used >= 2


def code_lens_chain(hist, refine_passes: int, max_len: int) -> list[dict]:
    """C2's shortest dependent path on each row of hist ([R, nsym]
    counts), in the steps of its algorithm as ``code_lens_mirror`` takes
    them on these counts: the spend's warp scan (log2 32 levels across
    the lanes and J = N / 32 in each), a reduction a clamp, a reduction a
    fix step, and a reduction a refinement pass (the ballots that find
    every length's A and B at once) with one step a level step of its
    scalar chain; a reduction is ``REDUCE_LEVELS`` levels.  The sort is
    not counted.  Per row: the counts and their sum, ``steps``."""
    out = []
    for row in np.asarray(hist, np.int64):
        c = Counter()
        code_lens_mirror(row, refine_passes, max_len, c)
        n_used = int((row > 0).sum())
        J = max(32, 1 << max(n_used - 1, 0).bit_length()) // 32
        d = {"scan": REDUCE_LEVELS + J, "clamps": c["spend clamp"],
             "fix": c["double"] + c["halve"] + c["halve an empty set"],
             "passes": c["refine move"] + c["refine fixed point"],
             "levels": c["level step"]}
        d["steps"] = d["scan"] + d["levels"] + REDUCE_LEVELS * (
            d["clamps"] + d["fix"] + d["passes"])
        out.append(d)
    return out
