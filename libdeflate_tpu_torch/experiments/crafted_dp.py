"""Crafted inputs for K1, the min-cost DP (``compress.kernels.dp_parse``):
the candidates and costs whose ties, caps, packed-field overlaps and
infeasible edges a DP kernel must get exactly right.

The CPU tests hold the plain version against interpret-mode Pallas on
these sets (``tests/test_torch_dp_crafted.py``), and ``chip_smoke.py``
holds the CUDA kernel against the plain version on the same sets.

Every set is one batch of B = 2 chunks of n_pad = 512 positions cut into
S = 256-position lanes (the tests' one interpret-mode shape):
``dp_sets()[name] = (arrays, lc)``, where ``arrays`` is the twelve int64
[2, 512] arrays in ``dp_parse`` order (cost_lit, lenA, dA, cdA, lenB, dB,
cdB, lenC, dC, cdC, d3, cd3) and ``lc`` the int64 per-length match costs,
[259] or one row per chunk [2, 259].  Every value lies in int32, and the
match costs are non-negative.

- every edge costs the same per byte (literal, rungs, tail and d3), so
  literal, rungs and tail tie everywhere;
- B or C longer than A, with equal offset costs;
- d3 > 0 with its cost equal to, one below and one above the cheapest
  offset cost at length 3;
- every cap exceeded: literal costs above 255, offset costs above 1023,
  lc above 2**20, and per-chunk lc rows that differ;
- distances of 65536 and more (the output word's span/dist overlap),
  distances of 2**18 and more (they spill into the length), and d3 of
  2**14 and more and of 2**22 and more (it spills into the literal cost
  and the C offset cost);
- lengths 0-2, 259-8191 and 8192 or more (the packed length's sign bit);
- negative costs, distances and lengths (the int32 packing of negative
  fields);
- all-literal chunks at literal cost 255 (and above) with every match
  infeasible, which holds the cost at its largest, 255 * (S - t).

``random_inputs`` is the JAX package's own DP test generator at any
shape, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compress import optimal

DP_B, DP_NPAD, DP_S = 2, 512, 256
LC_ENTRIES = 259


def _lc_seed() -> np.ndarray:
    """A plausible per-length cost table: 112 + 16 per extra bit."""
    f = np.arange(LC_ENTRIES)
    lc = 112 + 16 * np.clip(np.floor(np.log2(np.maximum(f - 3, 1))) - 1,
                            0, 5).astype(np.int64)
    lc[:3] = 1 << 28
    return lc


def _random_matches(rng, lo=0, hi=259, dmax=32769):
    """(len, dist) arrays for A, B, C with len(B), len(C) <= len(A)."""
    shape = (DP_B, DP_NPAD)
    lenA = rng.integers(lo, hi, shape)
    lenB = np.minimum(rng.integers(lo, hi, shape), lenA)
    lenC = np.minimum(rng.integers(lo, hi, shape), lenA)
    return [(ln, rng.integers(1, dmax, shape)) for ln in (lenA, lenB, lenC)]


def _assemble(cost_lit, matches, costs, d3, cd3, lc):
    (lA, dA), (lB, dB), (lC, dC) = matches
    cA, cB, cC = costs
    arrays = tuple(np.asarray(a, np.int64) for a in
                   (cost_lit, lA, dA, cA, lB, dB, cB, lC, dC, cC, d3, cd3))
    lc = np.asarray(lc, np.int64)
    if any(a.shape != (DP_B, DP_NPAD) or a.min() < -(1 << 31)
           or a.max() >= 1 << 31 for a in arrays) \
            or lc.min() < 0 or lc.max() >= 1 << 31:
        raise ValueError("a crafted DP set leaves its shape or int32")
    return arrays, lc


def dp_sets(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    shape = (DP_B, DP_NPAD)
    full = np.full
    sets = {}

    # every edge 20 bits a byte: a rung of length f costs 20 + 20(f-1)
    lc = 20 * (np.arange(LC_ENTRIES) - 1)
    lc[:3] = 1 << 20
    sets["every edge ties"] = _assemble(
        full(shape, 20), _random_matches(rng), [full(shape, 20)] * 3,
        np.where(rng.random(shape) < 0.5, rng.integers(1, 8193, shape), 0),
        full(shape, 40), lc)

    m = _random_matches(rng, 0, 200)
    lenB = m[0][0] + rng.integers(0, 60, shape)
    lenC = m[0][0] + rng.integers(0, 60, shape)
    cost = rng.integers(80, 120, shape)
    sets["B or C longer than A, equal offset costs"] = _assemble(
        rng.integers(16, 180, shape),
        [m[0], (lenB, m[1][1]), (lenC, m[2][1])], [cost] * 3,
        np.where(rng.random(shape) < 0.3, rng.integers(1, 8193, shape), 0),
        cost, _lc_seed())

    m = _random_matches(rng)
    costs = [rng.integers(80, 112, shape) for _ in range(3)]
    lens = np.stack([x[0] for x in m])
    cmin = np.min(np.where(lens >= 3, np.stack(costs), 1 << 20), 0)
    cmin = np.where(cmin == 1 << 20, 90, cmin)
    sets["d3 at, below and above the cheapest offset cost"] = _assemble(
        rng.integers(16, 180, shape), m, costs,
        rng.integers(1, 8193, shape),
        cmin + rng.integers(-1, 2, shape), _lc_seed())

    lc2 = np.stack([_lc_seed(), _lc_seed()])
    lc2[0, 3:] += rng.integers(0, 3 << 20, LC_ENTRIES - 3)
    lc2[1, 3:] = np.maximum(lc2[1, 3:] - 60, 1)
    lc2[1, 100:200] = (1 << 20) + rng.integers(0, 1 << 22, 100)
    sets["every cap exceeded, per-chunk lc"] = _assemble(
        rng.integers(150, 1000, shape), _random_matches(rng),
        [rng.integers(500, 5000, shape) for _ in range(3)],
        np.where(rng.random(shape) < 0.5, rng.integers(1, 8193, shape), 0),
        rng.integers(500, 5000, shape), lc2)

    m = _random_matches(rng, 0, 259, 1 << 20)
    d3 = np.where(rng.random(shape) < 0.5, rng.integers(1, 1 << 15, shape),
                  rng.integers(1 << 22, 1 << 24, shape))
    sets["distances past 16 and 18 bits, d3 past 14 and 22 bits"] = \
        _assemble(rng.integers(16, 180, shape), m,
                  [rng.integers(80, 400, shape) for _ in range(3)],
                  np.where(rng.random(shape) < 0.7, d3, 0),
                  rng.integers(80, 400, shape), _lc_seed())

    def lengths():
        pick = rng.integers(0, 3, shape)
        return np.choose(pick, [rng.integers(0, 3, shape),
                                rng.integers(259, 8192, shape),
                                rng.integers(8192, 1 << 15, shape)])
    sets["lengths 0-2, 259-8191 and 8192 or more"] = _assemble(
        rng.integers(16, 180, shape),
        [(lengths(), rng.integers(1, 32769, shape)) for _ in range(3)],
        [rng.integers(80, 300, shape) for _ in range(3)],
        np.where(rng.random(shape) < 0.5, rng.integers(1, 8193, shape), 0),
        rng.integers(80, 300, shape), _lc_seed())

    def signed(lo, hi):
        return np.where(rng.random(shape) < 0.5, -rng.integers(1, -lo, shape),
                        rng.integers(0, hi, shape))
    sets["negative fields"] = _assemble(
        signed(-300, 180),
        [(signed(-300, 259), signed(-40000, 32769)) for _ in range(3)],
        [signed(-2000, 400) for _ in range(3)], signed(-9000, 8193),
        signed(-2000, 400), _lc_seed())

    sets["all literal at cost 255, no match feasible"] = _assemble(
        np.where(rng.random(shape) < 0.5, 255, rng.integers(256, 4000, shape)),
        [(rng.integers(-2, 3, shape), rng.integers(1, 32769, shape))
         for _ in range(3)],
        [rng.integers(80, 120, shape) for _ in range(3)],
        np.zeros(shape, np.int64), full(shape, 80), _lc_seed())
    return sets


def random_inputs(dev, B: int = 4, n_pad: int = 1 << 20, seed: int = 0):
    """The generator of the JAX package's DP kernel test
    (tests/test_pallas_kernels.py::test_dp_kernel_matches_xla) at [B,
    n_pad], with the seeded offset and match costs: the thirteen
    arguments of ``dp_parse`` before S, on ``dev``."""
    rng = np.random.default_rng(seed)
    shape = (B, n_pad)
    cost_lit = rng.integers(16, 180, shape)
    lenA = rng.integers(0, 259, shape)
    dA = rng.integers(1, 32769, shape)
    lenB = np.minimum(rng.integers(0, 259, shape), lenA)
    dB = rng.integers(1, 32769, shape)
    d3 = np.where(rng.random(shape) < 0.5, rng.integers(1, 8193, shape), 0)
    lenC = np.minimum(rng.integers(0, 259, shape), lenA)
    dC = rng.integers(1, 32769, shape)

    def t(a):
        return torch.as_tensor(a, device=dev)

    lA, lB, lC = t(lenA), t(lenB), t(lenC)
    dAt, dBt, dCt, d3t = t(dA), t(dB), t(dC), t(d3)
    dc = optimal.dist_cost
    return (t(cost_lit), lA, dAt, dc(dAt), lB, dBt, dc(dBt), lC, dCt,
            dc(dCt), d3t, dc(d3t), t(optimal.SEED_LC_LEN))
