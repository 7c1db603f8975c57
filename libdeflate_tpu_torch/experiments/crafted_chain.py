"""Crafted inputs for C3 and C4, the candidates' chain extension
(``compress/chain_kernels.py``), and numpy mirrors of the two kernels'
schedule.

``relax_sets(K)[name]`` is a list of K (mlen, dist, fine) int64 arrays
of shape [CHAIN_B, CHAIN_N] for C3 (``chain_extend_multi``);
``double_sets(nc)[name]`` one (nc = 1, ``chain_extend``) or two (nc = 2,
``chain_extend2``) such triples for C4.  Rows are CHAIN_N = 5000
positions, a multiple of no tile the checks use (64, 256, 1024), so that
every row ends in a partial tile.  The sets hold:

- chains of one distance over thousands of positions, which the
  relaxation and the doubling carry across many tiles and past 258
  before the clamp;
- ties: several candidates at one distance with equal lengths and
  different remainders, where the earlier j must win (C3), and equal
  final lengths of A and B at different distances, where A wins (C4);
- dist 0 in every candidate, which the comparisons match like any other
  distance;
- initial lengths past 258 and negative ones (a negative r takes the
  cand of 0 in C3);
- chains that run into a row's last positions, where ``ahead`` reads
  zeros (in C4 a match of exactly s bytes at dist 0 there takes the zero
  remainder);
- C4's splices from the other candidate (tA2, tB1, tB2);
- random lengths over a few distances.

``relax_mirror`` and ``double_mirror`` follow the kernels of
``csrc/chain_extend.cu`` step by step: the persistent grid's runs of
flat (row, tile) indices (``blocks`` blocks), each walked from its
highest tile down; the prologue above a run that does not start at its
row's last tile; at each step the level of the tile above carried into
the positions past the tile (zeros past the row's end) and the tile's
own first s positions saved for the tile below; every new value computed
from the old ones, then written.  With ``stats`` (a Counter) they count
what the crafted sets must reach: splices taken from the carried
positions (``halo``), reads past the row's end inside a tile
(``zero_fill``) and changes made from them (``zero_take``), visible ties
(``tie``: a later j as long as the best so far, with another
remainder), lengths past 258 before the clamp (``over_258``), C4's four
splice kinds and equal final lengths of A and B (``tie_ab``), and the
walk's own: prologues (``prologue``), tiles walked past a run's first
(``walk``), runs that cross into another row (``row_cross``), tiles of
rows shorter than a tile (``short_row``) and tiles whose next tile down
(the one loaded meanwhile) ends a row part way (``end_in_prefetch``).
``relax_shape_sets`` and ``double_shape_sets`` hold rows of other
shapes (``SHAPES``) for those.  The CPU
tests hold the mirrors and the plain versions to each other and to the
JAX package; ``chip_smoke.py`` holds the kernels to the plain versions
on the same sets, at the same tiles.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

CHAIN_B, CHAIN_N = 2, 5000
STRIDES = (1, 2, 4, 8, 16, 32, 64, 128)
# the stride sets the repository's callers pass: (strides1, strides2)
STRIDE_SETS = {
    "two default rounds": (STRIDES, STRIDES),
    "one default round (lean)": (STRIDES, ()),
    "s5 (1, 2, 8, 32, 128) then (32, 64, 128)": ((1, 2, 8, 32, 128),
                                                 (32, 64, 128)),
    "s4 (1, 4, 16, 128) then the defaults": ((1, 4, 16, 128), STRIDES),
    "the defaults then (32, 64, 128)": (STRIDES, (32, 64, 128)),
    "s4 (1, 4, 16, 128) alone": ((1, 4, 16, 128), ()),
}
RELAX_KS = (2, 3, 5)
DOUBLE_STRIDES = (8, 16, 32, 64, 128, 256)   # every power of two below 258
MIRROR_TILES = (64, 256)        # below the 510 of two rounds' halo
TILE = 1024                     # the wrappers' tile
BLOCKS = 264                    # a grid the card runs (132 SMs x 2)
MAX_LEN = 258


def runs(tiles: int, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """The persistent grid's runs: (first, end) flat tile indices of each
    of min(tiles, blocks) blocks, balanced to within one tile."""
    g = min(tiles, blocks)
    per, extra = divmod(tiles, g)
    b = np.arange(g)
    g0 = b * per + np.minimum(b, extra)
    return g0, g0 + per + (b < extra)


def _final(r: np.ndarray, f: np.ndarray) -> np.ndarray:
    r = r.astype(np.int64)
    return np.minimum(r + np.where(r >= 4, f.astype(np.int64), 0), MAX_LEN)


def _schedule(arrays, strides, tile, blocks, step, stats):
    """The walk shared by both mirrors: ``arrays`` K (mlen, dist, fine)
    triples [rows, n]; ``step(r, d, f, rs, ds, fs, s)`` gives the new (r,
    f) of positions whose old values are (r, d, f) from the old values
    (rs, ds, fs) s ahead, every array [K, blocks, positions].  Returns
    (r, f) [K, rows, n] after the last step.

    As the kernel: each block walks its run of flat (row, tile) indices
    down; a run that does not start at its row's last tile first steps
    the original ``sum(strides)`` positions above its first tile through a
    region shrinking by s each step (the prologue); at step q a tile
    takes above it the level q - 1 of the tile above (the carry, zeros
    above a row's last tile) and the original d, saves its own first s
    positions' level q - 1 into the carry, computes every new value from
    the old ones (the registers), then writes them (not after the last
    step)."""
    rows, n = np.asarray(arrays[0][0]).shape
    K, T = len(arrays), tile
    H, smax = sum(strides), max(strides, default=0)
    per_row = -(-n // T)
    g0, g1 = runs(rows * per_row, blocks)
    G = len(g0)
    span = per_row * T + max(T + smax, H)
    R, D, F = (np.stack([np.concatenate(
        [np.asarray(c[i]), np.zeros((rows, span - n), np.int64)], 1)
        for c in arrays]).astype(np.int32) for i in range(3))
    cr = np.zeros((K, G, H), np.int32)
    cf = np.zeros((K, G, H), np.int32)
    out_r = np.zeros((K, rows, per_row * T), np.int32)
    out_f = np.zeros((K, rows, per_row * T), np.int32)
    count = stats if stats is not None else Counter()

    row, col = np.divmod(g1 - 1, per_row)
    pro = np.flatnonzero(col != per_row - 1)       # the prologues
    count["prologue"] += len(pro)
    if len(pro):
        idx = (col[pro] * T + T)[:, None] + np.arange(H)[None]
        br, bd, bf = (X[:, row[pro, None], idx] for X in (R, D, F))
        valid, off = H, 0
        for s in strides:
            cr[:, pro, off:off + s] = br[:, :, :s]
            cf[:, pro, off:off + s] = bf[:, :, :s]
            valid -= s
            nr, nf = step(br[:, :, :valid], bd[:, :, :valid],
                          bf[:, :, :valid], br[:, :, s:s + valid],
                          bd[:, :, s:s + valid], bf[:, :, s:s + valid], s)
            br[:, :, :valid], bf[:, :, :valid] = nr, nf
            off += s

    for w in range(int((g1 - g0).max())):
        live = g1 - 1 - w >= g0
        t = np.maximum(g1 - 1 - w, g0)
        row, col = np.divmod(t, per_row)
        a0 = col * T
        top = (col == per_row - 1)[None, :, None]
        count["walk"] += int(live.sum()) if w else 0
        count["row_cross"] += int((live & top[0, :, 0]).sum()) if w else 0
        count["short_row"] += int(live.sum()) if n < T else 0
        nxt = live & (t - 1 >= g0) & ((t - 1) % per_row == per_row - 1)
        count["end_in_prefetch"] += int(nxt.sum()) if n % T else 0
        idx = a0[:, None] + np.arange(T + smax)[None]
        xr, xd, xf = (X[:, row[:, None], idx] for X in (R, D, F))
        xr[:, :, T:], xf[:, :, T:] = 0, 0
        pos = idx[None]                 # each buffer position in its row
        r, f = xr[:, :, :T].copy(), xf[:, :, :T].copy()
        off = 0
        for q, s in enumerate(strides):
            xr[:, :, T:T + s] = np.where(top, 0, cr[:, :, off:off + s])
            xf[:, :, T:T + s] = np.where(top, 0, cf[:, :, off:off + s])
            cr[:, :, off:off + s] = xr[:, :, :s]
            cf[:, :, off:off + s] = xf[:, :, :s]
            nr, nf = step(r, xd[:, :, :T], f, xr[:, :, s:s + T],
                          xd[:, :, s:s + T], xf[:, :, s:s + T], s)
            took = ((nr != r) | (nf != f)) & live[None, :, None]
            past = live[None, :, None] & (pos[:, :, s:s + T] >= n)
            count["halo"] += int(took[:, :, max(T - s, 0):].sum())
            count["zero_fill"] += int(past.sum())
            count["zero_take"] += int((took & past).sum())
            r, f = nr, nf
            if q + 1 < len(strides):
                xr[:, :, :T], xf[:, :, :T] = r, f
            off += s
        out_r[:, row[live, None], idx[live, :T]] = r[:, live]
        out_f[:, row[live, None], idx[live, :T]] = f[:, live]
    r, f = out_r[:, :, :n], out_f[:, :, :n]
    rt = r.astype(np.int64)
    count["over_258"] += int((rt + np.where(rt >= 4, f, 0) > MAX_LEN).sum())
    return r, f


def relax_mirror(cands, strides1=STRIDES, strides2=STRIDES, tile=TILE,
                 blocks=BLOCKS, stats=None):
    """C3 (``chain_relax``) on numpy: [(len, dist)] per candidate of the
    K (mlen, dist, fine) [rows, n] triples ``cands``, with the kernel's
    arithmetic: j = 0 as the plain loop (a cand of 0 where it cannot
    match, which a negative r takes), a later j only where it can match
    with s + its r strictly longer."""
    K = len(cands)

    def step(r, d, f, rs, ds, fs, s):
        srs = rs + np.int32(s)
        nr, nf = r.copy(), f.copy()
        for k in range(K):
            can = r[k] >= s
            for j in range(K):
                match = can & (ds[j] == d[k])
                if stats is not None:
                    stats["tie"] += int((match & (srs[j] == nr[k])
                                         & (fs[j] != nf[k])).sum())
                if j == 0:
                    cand = np.where(match, srs[0], 0)
                    better = cand > nr[k]
                    nr[k] = np.where(better, cand, nr[k])
                else:
                    better = match & (srs[j] > nr[k])
                    nr[k] = np.where(better, srs[j], nr[k])
                nf[k] = np.where(better, fs[j], nf[k])
        return nr, nf

    r, f = _schedule(cands, tuple(strides1) + tuple(strides2), tile, blocks,
                     step, stats)
    return [(_final(r[k], f[k]), np.asarray(cands[k][1])) for k in range(K)]


def double_mirror(cands, tile=TILE, blocks=BLOCKS, stats=None):
    """C4 (``chain_double``) on numpy: (len, dist) of one (nc = 1,
    ``chain_extend``) or two (``chain_extend2``) (mlen, dist, fine)
    [rows, n] triples ``cands``."""
    nc = len(cands)

    def step(r, d, f, rs, ds, fs, s):
        if nc == 1:
            take = (r[0] == s) & (ds[0] == d[0])
            if stats is not None:
                stats["take"] += int(take.sum())
            return (np.where(take, r[0] + rs[0], r[0])[None],
                    np.where(take, fs[0], f[0])[None])
        rA, rB, dA, dB = r[0], r[1], d[0], d[1]
        tA1 = (rA == s) & (ds[0] == dA)
        tA2 = (rA == s) & ~tA1 & (ds[1] == dA)
        tB1 = (rB == s) & (ds[0] == dB)
        tB2 = (rB == s) & ~tB1 & (ds[1] == dB)
        if stats is not None:
            for name, t in (("tA1", tA1), ("tA2", tA2), ("tB1", tB1),
                            ("tB2", tB2)):
                stats[name] += int(t.sum())
        nr = np.stack([rA + np.where(tA1, rs[0], np.where(tA2, rs[1], 0)),
                       rB + np.where(tB1, rs[0], np.where(tB2, rs[1], 0))])
        nf = np.stack([np.where(tA1, fs[0], np.where(tA2, fs[1], f[0])),
                       np.where(tB1, fs[0], np.where(tB2, fs[1], f[1]))])
        return nr, nf

    r, f = _schedule(cands, DOUBLE_STRIDES, tile, blocks, step, stats)
    lens = [_final(r[k], f[k]) for k in range(nc)]
    if nc == 1:
        return lens[0], np.asarray(cands[0][1])
    use_b = lens[1] > lens[0]
    if stats is not None:
        stats["tie_ab"] += int(((lens[1] == lens[0])
                                & (np.asarray(cands[0][1])
                                   != np.asarray(cands[1][1]))
                                & (lens[0] > 0)).sum())
    return (np.where(use_b, lens[1], lens[0]),
            np.where(use_b, np.asarray(cands[1][1]),
                     np.asarray(cands[0][1])))


# ---- the crafted sets ---------------------------------------------------

def _noise(rng, shape, dists=(1, 2, 3, 512, 1000)):
    return (4 * rng.integers(0, 9, shape), rng.choice(dists, shape),
            rng.integers(0, 4, shape))


def relax_sets(K: int, seed: int = 0) -> dict:
    """C3's crafted sets for K candidates (see the module's docstring)."""
    rng = np.random.default_rng(seed + 100 * K)
    shape = (CHAIN_B, CHAIN_N)
    sets = {}

    def blank():
        return [list(_noise(rng, shape)) for _ in range(K)]

    c = blank()                 # one distance over 3000 positions
    for k in range(K):
        c[k][0][:, 300:3300] = 4 * rng.integers(1, 9, (CHAIN_B, 3000))
        c[k][1][:, 300:3300] = 700 if k % 2 == 0 else 701
    c[0][1][1, 1000:2500] = 701
    sets["chains across tiles"] = c
    c = blank()                 # equal lengths, different remainders
    for k in range(K):
        c[k][0][:, 500:2500] = 16
        c[k][1][:, 500:2500] = 512
        c[k][2][:, 500:2500] = (k + np.arange(2000)) % 4
    sets["ties between j"] = c
    c = blank()
    for k in range(K):
        zero = rng.random(shape) < 0.6
        c[k][1][zero] = 0
        c[k][0][:, 1200:1800] = 4 * rng.integers(2, 9, (CHAIN_B, 600))
        c[k][1][:, 1200:1800] = 0
    sets["dist 0"] = c
    c = blank()
    for k in range(K):
        big = rng.random(shape) < 0.1
        c[k][0][big] = rng.choice([200, 256, 257, 258, 300, 1000, 70000],
                                  int(big.sum()))
        c[k][1][:, 2000:4000] = 300
        c[k][2][big] = 3
    sets["lengths past 258"] = c
    c = blank()                 # chains into the row's last positions
    for k in range(K):
        c[k][0][:, -700:] = 32
        c[k][1][:, -700:] = 9 if k < 2 else 0
        c[k][0][:, -3:] = 4
    sets["the row's last positions"] = c
    c = blank()
    for k in range(K):
        neg = rng.random(shape) < 0.2
        c[k][0][neg] = rng.choice([-1, -4, -300], int(neg.sum()))
        c[k][2][rng.random(shape) < 0.1] = -2
    sets["negative lengths and remainders"] = c
    sets["random"] = blank()
    return {name: [tuple(np.asarray(x, np.int64) for x in t) for t in c]
            for name, c in sets.items()}


def double_sets(nc: int, seed: int = 0) -> dict:
    """C4's crafted sets for one or two candidates (see the module's
    docstring)."""
    rng = np.random.default_rng(seed + 7 * nc)
    shape = (CHAIN_B, CHAIN_N)
    sets = {}

    def blank():
        c = [list(_noise(rng, shape)) for _ in range(nc)]
        for t in c:             # lengths at the strides, to take splices
            hit = rng.random(shape) < 0.3
            t[0][hit] = rng.choice(DOUBLE_STRIDES, int(hit.sum()))
        return c

    c = blank()                 # 8-byte links of one distance: 8 -> 512
    for k in range(nc):
        c[k][0][:, 200:3200] = 8
        c[k][1][:, 200:3200] = 300 + k
        c[k][2][:, 200:3200] = 3
    sets["doubling across tiles"] = c
    c = blank()
    for k in range(nc):
        c[k][1][rng.random(shape) < 0.6] = 0
        c[k][0][:, 1000:1600] = 8
        c[k][1][:, 1000:1600] = 0
    sets["dist 0"] = c
    c = blank()                 # r == s at dist 0 near the row's end
    for k in range(nc):
        c[k][0][:, -520:] = rng.choice(DOUBLE_STRIDES, (CHAIN_B, 520))
        c[k][1][:, -520:] = 0
        c[k][2][:, -520:] = 2
        c[k][1][1, -200:] = 77
    sets["the row's last positions"] = c
    c = blank()
    for k in range(nc):
        big = rng.random(shape) < 0.1
        c[k][0][big] = rng.choice([256, 257, 300, 1000], int(big.sum()))
        c[k][2][big] = 3
        neg = rng.random(shape) < 0.05
        c[k][0][neg] = -8
    sets["lengths past 258 and negative"] = c
    if nc == 2:
        c = blank()             # A continues through B and B through A
        a, b = c
        a[0][:, 500:3500], b[0][:, 500:3500] = 8, 8
        a[1][:, 500:3500] = np.where(np.arange(3000) % 16 < 8, 100, 200)
        b[1][:, 500:3500] = np.where(np.arange(3000) % 16 < 8, 200, 100)
        sets["splices through the other candidate"] = c
        c = blank()             # equal final lengths at two distances
        a, b = c
        b[0][:], b[2][:], b[1][:] = a[0], a[2], a[1] + 1
        sets["ties between A and B"] = c
    sets["random"] = blank()
    return {name: [tuple(np.asarray(x, np.int64) for x in t) for t in c]
            for name, c in sets.items()}


# rows of other shapes (rows, n), for the walk's own traps: every row
# shorter than the smallest tile the checks use (64), and short rows of
# several tiles each, the last partial, so that a run crosses rows and
# the tile it loads next ends a row.  SHAPE_BLOCKS is a grid smaller
# than their tiles at every checked tile, so that runs walk.
SHAPES = {"rows shorter than a tile": (6, 50),
          "short rows of several tiles": (40, 300)}
SHAPE_BLOCKS = 24
# more rows than one grid dimension held (65535), for the card only
TALL_SHAPE = (66000, 24)


def _shaped(rng, K: int, shape, lengths) -> list:
    """K (mlen, dist, fine) triples of ``shape``: noise, a chain of one
    distance over the middle half of every row, dist 0, negative lengths
    (one at each row's last position); ``lengths`` the lengths the chain
    and the last positions take."""
    rows, n = shape
    c = [list(_noise(rng, shape)) for _ in range(K)]
    lo, hi = n // 4, n - n // 4
    for k in range(K):
        c[k][0][:, lo:hi] = rng.choice(lengths, (rows, hi - lo))
        c[k][1][:, lo:hi] = 700 + k % 2
        c[k][1][rng.random(shape) < 0.1] = 0
        c[k][0][rng.random(shape) < 0.05] = -4
        c[k][0][:, -3:] = lengths[0]
        c[k][0][:, -1] = -4     # takes the zero above the row's end
    return [tuple(np.asarray(x, np.int64) for x in t) for t in c]


def relax_shape_sets(K: int, shapes=None, seed: int = 0) -> dict:
    """C3's sets of ``shapes`` (SHAPES by default) for K candidates."""
    rng = np.random.default_rng(seed + 1000 + K)
    return {name: _shaped(rng, K, shape, (4, 8, 16, 32))
            for name, shape in (shapes or SHAPES).items()}


def double_shape_sets(nc: int, shapes=None, seed: int = 0) -> dict:
    """C4's sets of ``shapes`` (SHAPES by default) for one or two
    candidates."""
    rng = np.random.default_rng(seed + 2000 + nc)
    return {name: _shaped(rng, nc, shape, (8,) + DOUBLE_STRIDES)
            for name, shape in (shapes or SHAPES).items()}
