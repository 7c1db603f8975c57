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
``csrc/chain_extend.cu`` step by step: each row cut into tiles of
``tile`` positions, each tile loaded with a halo of the strides' sum and
zero past the row's end, the region updated shrinking by s each step and
updated in place in chunks of the block's ``threads`` positions in
ascending order (a chunk's reads, then its writes), the final lengths
from the tile's first ``tile`` positions.  With ``stats`` (a Counter)
they count what the crafted sets must reach: splices taken from the
halo (``halo``), reads past the row's end inside the updated region
(``zero_fill``) and changes made from them (``zero_take``), visible ties
(``tie``: a later j as long as the best so far, with another
remainder), lengths past 258 before the clamp (``over_258``), C4's four
splice kinds and equal final lengths of A and B (``tie_ab``).  The CPU
tests hold the mirrors and the plain versions to each other and to the
JAX package; ``chip_smoke.py`` holds the kernels to the plain versions
on the same sets, at the same tiles.
"""

from __future__ import annotations


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
THREADS = 512                   # chain_extend.cu's kThreads
MAX_LEN = 258


def _tiles(x: np.ndarray, tile: int, halo: int) -> np.ndarray:
    """[rows * tiles, tile + halo] windows of x [rows, n], zero past each
    row's end."""
    rows, n = x.shape
    t0 = np.arange(0, n, tile)
    idx = t0[:, None] + np.arange(tile + halo)[None, :]
    pad = np.concatenate([x, np.zeros((rows, tile + halo), x.dtype)], 1)
    return pad[:, np.minimum(idx, n)].reshape(-1, tile + halo)


def _untile(v: np.ndarray, rows: int, n: int, tile: int) -> np.ndarray:
    return v[:, :tile].reshape(rows, -1)[:, :n]


def _final(r: np.ndarray, f: np.ndarray) -> np.ndarray:
    r = r.astype(np.int64)
    return np.minimum(r + np.where(r >= 4, f.astype(np.int64), 0), MAX_LEN)


def _schedule(arrays, strides, tile, threads, step, stats):
    """The tile schedule shared by both mirrors: ``arrays`` K (mlen,
    dist, fine) triples [rows, n]; ``step(r, d, f, p, s)`` gives the new
    (r, f) [K, tiles, len(p)] of the tile positions p.  Returns (r, f,
    d) [K, tiles, tile + halo] after the last step."""
    rows, n = np.asarray(arrays[0][0]).shape
    halo = sum(strides)
    W = tile + halo
    r, d, f = (np.stack([_tiles(np.asarray(c[i]), tile, halo)
                         for c in arrays]).astype(np.int32)
               for i in range(3))
    pos = (np.arange(0, n, tile)[None, :, None]
           + np.arange(W)[None, None, :])
    pos = np.broadcast_to(pos, (rows,) + pos.shape[1:]).reshape(-1, W)
    valid = W
    for s in strides:
        valid -= s
        for c in range(0, valid, threads):
            p = np.arange(c, min(c + threads, valid))
            nr, nf = step(r, d, f, p, s)
            if stats is not None:
                took = (nr != r[:, :, p]) | (nf != f[:, :, p])
                past = pos[:, p + s] >= n
                stats["halo"] += int(took[:, :, p + s >= tile].sum())
                stats["zero_fill"] += int(past.sum())
                stats["zero_take"] += int((took & past[None]).sum())
            r[:, :, p] = nr
            f[:, :, p] = nf
    if stats is not None:
        rt = r[:, :, :tile].astype(np.int64)
        inside = pos[None, :, :tile] < n
        stats["over_258"] += int(((rt + np.where(rt >= 4, f[:, :, :tile], 0)
                                   > MAX_LEN) & inside).sum())
    return r, d, f


def relax_mirror(cands, strides1=STRIDES, strides2=STRIDES, tile=1024,
                 threads=THREADS, stats=None):
    """C3 (``chain_relax``) on numpy: [(len, dist)] per candidate of the
    K (mlen, dist, fine) [rows, n] triples ``cands``."""
    K = len(cands)
    rows, n = np.asarray(cands[0][0]).shape

    def step(r, d, f, p, s):
        rs, ds, fs = r[:, :, p + s], d[:, :, p + s], f[:, :, p + s]
        nr, nf = r[:, :, p].copy(), f[:, :, p].copy()
        for k in range(K):
            can = r[k][:, p] >= s
            for j in range(K):
                cand = np.where(can & (ds[j] == d[k][:, p]), s + rs[j], 0)
                if stats is not None:
                    stats["tie"] += int(((cand == nr[k]) & can
                                         & (ds[j] == d[k][:, p])
                                         & (fs[j] != nf[k])).sum())
                better = cand > nr[k]
                nf[k] = np.where(better, fs[j], nf[k])
                nr[k] = np.where(better, cand, nr[k])
        return nr, nf

    r, _, f = _schedule(cands, tuple(strides1) + tuple(strides2), tile,
                        threads, step, stats)
    return [(_untile(_final(r[k], f[k]), rows, n, tile),
             np.asarray(cands[k][1])) for k in range(K)]


def double_mirror(cands, tile=1024, threads=THREADS, stats=None):
    """C4 (``chain_double``) on numpy: (len, dist) of one (nc = 1,
    ``chain_extend``) or two (``chain_extend2``) (mlen, dist, fine)
    [rows, n] triples ``cands``."""
    nc = len(cands)
    rows, n = np.asarray(cands[0][0]).shape

    def step(r, d, f, p, s):
        rs, ds, fs = r[:, :, p + s], d[:, :, p + s], f[:, :, p + s]
        if nc == 1:
            take = (r[0][:, p] == s) & (ds[0] == d[0][:, p])
            if stats is not None:
                stats["take"] += int(take.sum())
            return (np.where(take, r[0][:, p] + rs[0], r[0][:, p])[None],
                    np.where(take, fs[0], f[0][:, p])[None])
        rA, rB, dA, dB = r[0][:, p], r[1][:, p], d[0][:, p], d[1][:, p]
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
        nf = np.stack([np.where(tA1, fs[0], np.where(tA2, fs[1],
                                                      f[0][:, p])),
                       np.where(tB1, fs[0], np.where(tB2, fs[1],
                                                     f[1][:, p]))])
        return nr, nf

    r, _, f = _schedule(cands, DOUBLE_STRIDES, tile, threads, step, stats)
    lens = [_untile(_final(r[k], f[k]), rows, n, tile) for k in range(nc)]
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
