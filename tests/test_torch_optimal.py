"""The port's lean cost seeding and plain DP against the JAX package's.

libdeflate_tpu_torch/compress/optimal.py and kernels.dp_parse_plain
against libdeflate_tpu/compress/tpu_optimal.py: the constant tables the
port derives itself (ladders, _SEED_LC_LEN, and tpu_dynamic's
_T_STATIC_ALL, _HDR_VALS/_HDR_OFFS/_LENS_OFF, _P19_*), the literal-cost
seeding of _literal_costs (sample 32) -- its float32 logarithm, a sweep
of every count h <= total over totals 1..32768 (every total to 2048, every
8th above), and the whole function on seeded chunks --, _dist_cost,
_commit, and the plain DP against _dp_parse on the generator of
tests/test_pallas_kernels.py::test_dp_kernel_matches_xla (S=256, B=2)
and at S=1024 on a parsed chunk.  Tolerance: exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import (bits, dynamic, kernels, optimal,
                                          pipeline)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,port,ref", [
    ("LEN_LADDER_DENSE2", kernels.LEN_LADDER_DENSE2, to.LEN_LADDER_DENSE2),
    ("_SEED_LC_LEN", optimal.SEED_LC_LEN, to._SEED_LC_LEN),
    ("_T_STATIC_ALL", dynamic.T_STATIC_ALL, td._T_STATIC_ALL),
    ("_HDR_VALS", dynamic.HDR_VALS, td._HDR_VALS),
    ("_HDR_OFFS", dynamic.HDR_OFFS, td._HDR_OFFS),
    ("_LENS_OFF", dynamic.LENS_OFF, td._LENS_OFF),
    ("_P19_LENS", dynamic.P19_LENS, td._P19_LENS),
    ("_P19_TAB", dynamic.P19_TAB, td._P19_TAB),
    ("_P19_LENS_PERM", dynamic.P19_LENS_PERM, td._P19_LENS_PERM),
    ("scalars", (optimal.DP_SEG, kernels.WIN, optimal.BIT,
                 optimal.LEN_SYM_COST, optimal.DIST_SYM_COST,
                 dynamic.DYN_CAPW, dynamic.HDR_BITS, bits.MULT,
                 bits.SORT_SEG, bits.FSM_SEG),
     (to.DP_SEG, to._WIN, to.BIT, to.LEN_SYM_COST, to.DIST_SYM_COST,
      td.DYN_CAPW, td.HDR_BITS, tp.MULT, tp.SORT_SEG, tp.FSM_SEG)),
])
def test_constant_tables(name, port, ref):
    p, r = np.asarray(port), np.asarray(ref)
    assert p.shape == r.shape and np.array_equal(p.astype(np.int64),
                                                 r.astype(np.int64)), name


def test_xla_log_matches_jnp_log():
    v = np.concatenate([
        np.arange(1, (1 << 21) + 1, dtype=np.float32),
        np.random.default_rng(0).random(1 << 20).astype(np.float32) * 1e4
        + np.float32(1e-3)])
    want = np.asarray(jnp.log(jnp.asarray(v)))
    got = optimal.xla_log_f32(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@jax.jit
def _jax_seed_costs(total, h):
    """tpu_optimal._literal_costs lines 170-174 over a [totals, h] grid."""
    tf = jnp.maximum(total, 1).astype(jnp.float32)[:, None]
    bits = (jnp.log2(tf)
            - jnp.log2(jnp.maximum(h, 1).astype(jnp.float32))[None, :])
    cost = jnp.clip(jnp.round(16 * bits).astype(jnp.int32), 16, 240)
    return jnp.where(h[None, :] > 0, cost, 240)


SWEEP = [(1, 2049, 1)] + [(lo, min(lo + 4096, 32769), 8)
                          for lo in range(2049, 32769, 4096)] + [
    (32768, 32769, 1)]


@pytest.mark.parametrize("lo,hi,step", SWEEP)
def test_seed_cost_sweep(lo, hi, step):
    hmax = min(hi - 1, 32768)
    h = np.arange(0, hmax + 1, dtype=np.int64)
    for start in range(lo, hi, 256 * step):
        tot = np.arange(start, min(start + 256 * step, hi), step)
        want = np.asarray(_jax_seed_costs(jnp.asarray(tot, jnp.int32),
                                          jnp.asarray(h, jnp.int32)))
        got = optimal.seed_costs(torch.from_numpy(h)[None],
                                 torch.from_numpy(tot), most=hi).numpy()
        live = h[None, :] <= tot[:, None]
        bad = np.argwhere(live & (got != want))
        assert bad.size == 0, [(int(tot[i]), int(h[j])) for i, j in bad[:5]]


_jax_costs = {n: jax.jit(jax.vmap(
    lambda b, l, n=n: to._literal_costs(b, l, n, sample=32)[0]))
    for n in (1 << 16, 1 << 20)}


@pytest.mark.parametrize("n_pad,seed", [(1 << 16, 0), (1 << 16, 1),
                                        (1 << 16, 2), (1 << 20, 3)])
def test_literal_costs(n_pad, seed):
    rng = np.random.default_rng(seed)
    B = 4
    bufs = rng.integers(0, 256, (B, n_pad)).astype(np.uint8)
    lengths = rng.integers(1, n_pad + 1, B)
    lengths[0] = n_pad
    for k in range(B):
        p = rng.dirichlet(np.ones(256) * rng.choice([0.02, 0.3, 5.0]))
        bufs[k, ::32] = rng.choice(256, n_pad // 32, p=p)
    if n_pad == 1 << 16:   # counts that needed the exact XLA arithmetic
        for k, (tot, h) in enumerate([(945, 53), (1890, 53), (840, 411)]):
            bufs[k + 1, ::32] = np.where(np.arange(n_pad // 32) < h, 97, 98)
            lengths[k + 1] = tot * 32
    want = np.asarray(_jax_costs[n_pad](jnp.asarray(bufs),
                                        jnp.asarray(lengths, jnp.int32)))
    bp, lt = torch.from_numpy(bufs), torch.from_numpy(lengths)
    got = optimal.literal_costs(bp, lt, optimal.literal_cost_table(bp, lt))
    assert np.array_equal(got.numpy(), want)


def test_dist_cost():
    d = np.concatenate([np.arange(0, 32769), [40000, 65535, 1 << 18]])
    want = np.asarray(to._dist_cost(jnp.asarray(d, jnp.int32)))
    assert np.array_equal(optimal.dist_cost(torch.from_numpy(d)).numpy(),
                          want)


def _dp_generator():
    """The generator of test_dp_kernel_matches_xla (S=256, B=2)."""
    rng = np.random.default_rng(0)
    B, n_pad = 2, 512
    cost_lit = rng.integers(16, 180, (B, n_pad)).astype(np.int32)
    lenA = rng.integers(0, 259, (B, n_pad)).astype(np.int32)
    dA = rng.integers(1, 32769, (B, n_pad)).astype(np.int32)
    lenB = np.minimum(rng.integers(0, 259, (B, n_pad)), lenA).astype(np.int32)
    dB = rng.integers(1, 32769, (B, n_pad)).astype(np.int32)
    d3 = np.where(rng.random((B, n_pad)) < 0.5,
                  rng.integers(1, 8193, (B, n_pad)), 0).astype(np.int32)
    lenC = np.minimum(rng.integers(0, 259, (B, n_pad)), lenA).astype(np.int32)
    dC = rng.integers(1, 32769, (B, n_pad)).astype(np.int32)
    return 256, cost_lit, lenA, dA, lenB, dB, lenC, dC, d3


def _parsed_chunk():
    """Lean candidates and costs of one 64 KiB text chunk (S=1024)."""
    raw = (REPO / "SURVEY.md").read_bytes()
    n = 1 << 16
    b = np.frombuffer((raw * (n // len(raw) + 1))[:n], np.uint8).copy()
    bt, lt = torch.from_numpy(b)[None], torch.tensor([n])
    bp, _, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(bt, lt)
    cost = optimal.literal_costs(bp, lt, optimal.literal_cost_table(bp, lt))
    return (1024,) + tuple(x.numpy().astype(np.int32) for x in
                           (cost, lenA, dA, lenB, dB, lenC, dC, d3))


@pytest.mark.parametrize("source", ["generator", "parsed_chunk"])
def test_plain_dp_matches_xla_dp(source):
    S, cost_lit, lenA, dA, lenB, dB, lenC, dC, d3 = (
        _dp_generator() if source == "generator" else _parsed_chunk())
    B = cost_lit.shape[0]
    lc = jnp.asarray(to._SEED_LC_LEN)
    dp = jax.jit(functools.partial(to._dp_parse, S=S,
                                   ladder=to.LEN_LADDER_DENSE2))
    dc = to._dist_cost
    want_s, want_d = [], []
    for b in range(B):
        a = [jnp.asarray(x[b]) for x in (cost_lit, lenA, dA, lenB, dB,
                                         lenC, dC, d3)]
        s, d = dp(a[0], a[1], a[2], dc(a[2]), a[3], a[4], dc(a[4]), a[5],
                  a[6], dc(a[6]), a[7], dc(a[7]), lc)
        want_s.append(np.asarray(s))
        want_d.append(np.asarray(d))
    t = [torch.from_numpy(x.astype(np.int64)) for x in
         (cost_lit, lenA, dA, lenB, dB, lenC, dC, d3)]
    dct = optimal.dist_cost
    span, dist = kernels.dp_parse_plain(
        t[0], t[1], t[2], dct(t[2]), t[3], t[4], dct(t[4]), t[5], t[6],
        dct(t[6]), t[7], dct(t[7]), torch.from_numpy(to._SEED_LC_LEN), S)
    assert np.array_equal(span.numpy(), np.stack(want_s))
    assert np.array_equal(dist.numpy(), np.stack(want_d))


def test_plain_dp_reads_each_lanes_own_chunk_table():
    """A [B, 259] lc table is read per lane's chunk: chunk 1 with its
    own table gives what it gives alone."""
    S, cost_lit, lenA, dA, lenB, dB, lenC, dC, d3 = _dp_generator()
    t = [torch.from_numpy(x.astype(np.int64)) for x in
         (cost_lit, lenA, dA, lenB, dB, lenC, dC, d3)]
    dct = optimal.dist_cost
    args = (t[0], t[1], t[2], dct(t[2]), t[3], t[4], dct(t[4]), t[5], t[6],
            dct(t[6]), t[7], dct(t[7]))
    lc = torch.from_numpy(to._SEED_LC_LEN).to(torch.int64)
    lc2 = torch.stack([lc, torch.clamp(lc - 40, min=1)])
    both = kernels.dp_parse_plain(*args, lc2, S)
    alone = kernels.dp_parse_plain(*[a[1:] for a in args], lc2[1], S)
    assert torch.equal(both[0][1:], alone[0])
    assert torch.equal(both[1][1:], alone[1])


def test_commit():
    rng = np.random.default_rng(5)
    n = 4096
    span = np.where(rng.random(n) < 0.6, rng.integers(3, 259, n), 1)
    dist = np.where(span >= 3, rng.choice([1, 4, 64, 9000], n), 0)
    pos = np.arange(n)
    for length in (n, 3000):
        want = to._commit(jnp.asarray(span, jnp.int32),
                          jnp.asarray(dist, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jnp.int32(length),
                          1024)
        got = optimal.commit(torch.from_numpy(span)[None],
                             torch.from_numpy(dist)[None],
                             torch.from_numpy(pos)[None],
                             torch.tensor([length]), 1024)
        for g, w in zip(got, want):
            assert np.array_equal(g[0].numpy(), np.asarray(w))
