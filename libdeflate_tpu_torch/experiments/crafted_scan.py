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
"""

from __future__ import annotations

import numpy as np

COMMIT_B, COMMIT_N = 2, 4096
COMMIT_SEGS = (512, 1024)
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
