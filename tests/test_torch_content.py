"""The DP tiers' candidate and cost stages against the JAX package's.

libdeflate_tpu_torch/compress/pipeline.py, chain_kernels.py's plain
relaxation and optimal.py against
libdeflate_tpu/compress/tpu_pipeline.py and tpu_optimal.py:
_sorted_matchfind's return_triple branch with 32-byte payloads (depth 6
and 12), _content_sorted_matchfind (doublings 0 and 2, with and without
the wide payloads), _chain_extend_multi (two relaxation rounds, K = 5;
one round, K = 3), _literal_costs (samples 1 and 32, with its row cache
of four rows at 256 KiB, with a cost table), _code_lens_from_items,
_lc_len_from_lens, _take30 and the copied tables (LEN_LADDER,
_SHORT_BIAS16, the biased seed).  The JAX functions take one chunk and
run under vmap.

Inputs, made with numpy from fixed seeds: two 64 KiB chunks, this
repository's SURVEY.md text and 64-byte records with 5% noise, at live
lengths 65536 and 40000, and a 512-byte period of PERF_NOTES.md text
beside random bytes for the relaxation; items from the port's own lean
parse of those chunks.  Tolerance: exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import (bits, chain_kernels, kernels,
                                          optimal, pipeline)

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16
LENGTHS = (N, 40000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite may run its
    files in parallel workers, and torch's OpenMP regions on [B, 64 KiB]
    tensors slow down by orders of magnitude when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def batch(n=N):
    rng = np.random.default_rng(21)
    raw = (REPO / "SURVEY.md").read_bytes()
    text = np.frombuffer((raw * (n // len(raw) + 1))[:n], np.uint8)
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), n // 64)
    noise = rng.integers(0, 256, n, dtype=np.uint8)
    rec = np.where(rng.random(n) < 0.05, noise, rec).astype(np.uint8)
    return np.stack([text, rec])


def port_words(bufs, lengths, wide_window=False):
    """The port's matchfind inputs: (h, words, w4, w8, w12, wide, seg)."""
    (_, _, _, w, w4, w8, w12, h, seg, _, _) = pipeline._positions(
        torch.from_numpy(bufs.copy()), torch.tensor(lengths), wide_window)
    wide = tuple(bits.ahead(w, k) for k in (16, 20, 24, 28))
    return h, w, w4, w8, w12, wide, seg


def as_jax(x):
    return jnp.asarray(x.numpy().astype(np.uint32))


def assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)), \
            name


@pytest.mark.parametrize("name,port,ref", [
    ("LEN_LADDER", kernels.LEN_LADDER, to.LEN_LADDER),
    ("_SHORT_BIAS16", optimal.SHORT_BIAS16, to._SHORT_BIAS16),
    ("biased seed", optimal.seed_lc_len(optimal.SHORT_BIAS16),
     np.where(np.arange(259) < 3, 1 << 28,
              np.maximum(to._SEED_LC_LEN - to._SHORT_BIAS16, 1))),
    ("unbiased seed", optimal.seed_lc_len(), to._SEED_LC_LEN),
])
def test_copied_tables(name, port, ref):
    assert np.array_equal(np.asarray(port, np.int64),
                          np.asarray(ref, np.int64)), name


@pytest.mark.parametrize("depth", [6, 12])
def test_sorted_matchfind_wide_triple(depth):
    h, w, w4, w8, w12, wide, seg = port_words(batch(), LENGTHS)
    got = pipeline.sorted_matchfind_triple(h, (w, w4, w8, w12) + wide, seg,
                                           depth)
    fn = jax.jit(jax.vmap(lambda h, w, w4, w8, w12, *wd:
                          tp._sorted_matchfind(h, w, w4, w8, w12, seg,
                                               depth=depth,
                                               return_triple=True,
                                               wide=wd)))
    want = fn(*map(as_jax, (h, w, w4, w8, w12) + wide))
    for k, (g, wt) in enumerate(zip(got, want)):
        assert_same(g, wt, [f"{'ABC'[k]} {x}" for x in ("len", "dist",
                                                        "fine")])
    # the wide payloads measure lengths past 16
    assert int(got[0][0].max()) > 16


@pytest.mark.parametrize("doublings,use_wide", [(0, True), (2, True),
                                                (2, False)])
def test_content_sorted_matchfind(doublings, use_wide):
    h, w, w4, w8, w12, wide, seg = port_words(batch(), LENGTHS)
    wide = wide if use_wide else ()
    got = pipeline.content_sorted_matchfind(h, w, w4, w8, w12, seg, 4, wide,
                                            doublings)
    fn = jax.jit(jax.vmap(lambda h, w, w4, w8, w12, *wd:
                          tp._content_sorted_matchfind(
                              h, w, w4, w8, w12, seg, depth=4,
                              wide=wd or None, doublings=doublings)))
    want = fn(*map(as_jax, (h, w, w4, w8, w12) + wide))
    assert_same([x for t in got for x in t], want,
                [f"{c} {x}" for c in "DE" for x in ("len", "dist", "fine")])
    assert int((got[0][0] >= 4).sum()) > 1000


def relax_inputs(K, seed):
    """K word-granular (mlen, dist, fine) candidates over a 512-byte
    period of text beside random bytes: lengths 0-32 in steps of 4, few
    distances, so that chains splice at every stride in both rounds."""
    rng = np.random.default_rng(seed)
    shape = (2, N)
    out = []
    for k in range(K):
        mlen = 4 * rng.integers(0, 9, shape)
        mlen[:, 2000:6000] = 4 * (k + 1)
        dist = rng.choice([1, 2, 3, 512, 1000 + k], shape)
        dist[:, 2000:6000] = 512
        out.append([torch.from_numpy(x) for x in
                    (mlen, dist, rng.integers(0, 4, shape))])
    return out


@pytest.mark.parametrize("K,rounds", [(5, 2), (3, 1), (3, 2)])
def test_chain_extend_multi(K, rounds):
    cands = relax_inputs(K, K + rounds)
    strides2 = bits.STRIDES if rounds == 2 else ()
    got = chain_kernels.chain_extend_multi_plain(cands, strides2)
    fn = jax.vmap(lambda *x: tp._chain_extend_multi(
        [x[3 * k:3 * k + 3] for k in range(K)], strides2=strides2))
    want = fn(*(jnp.asarray(x.numpy(), jnp.int32) for c in cands
                for x in c))
    assert_same([x for p in got for x in p], [x for p in want for x in p],
                 [f"{k} {x}" for k in range(K) for x in ("len", "dist")])
    assert int(got[0][0].max()) == bits.MAX_LEN


def test_literal_costs_samples_and_cache():
    """Samples 1 and 32 at 64 KiB and 256 KiB (four cache rows at sample
    1), then a cost table with zeros translated with the cache given."""
    rng = np.random.default_rng(3)
    for n in (N, 4 * N):
        bufs = np.tile(batch(), (1, n // N))
        lengths = np.array([n, n - 12345])
        bt, lt = torch.from_numpy(bufs), torch.from_numpy(lengths)
        for sample in (1, 32):
            fn = jax.jit(jax.vmap(functools.partial(
                to._literal_costs, n_pad=n, sample=sample)))
            cost_j, cache_j = fn(jnp.asarray(bufs),
                                 jnp.asarray(lengths, jnp.int32))
            cost, cache = optimal.literal_costs_with(bt, lt, sample=sample)
            assert np.array_equal(cost.numpy(), np.asarray(cost_j))
            assert np.array_equal(cache.numpy(), np.asarray(cache_j))
            assert cache.shape[1] == max(n // sample // 65536, 1)
        table = rng.integers(0, 16, (2, 256)) * optimal.BIT
        table[:, ::7] = 0
        fn = jax.jit(jax.vmap(lambda b, l, t, c: to._literal_costs(
            b, l, n, table=t, cache=c)[0]))
        want = fn(jnp.asarray(bufs), jnp.asarray(lengths, jnp.int32),
                  jnp.asarray(table, jnp.int32), cache_j)
        got, same = optimal.literal_costs_with(bt, lt, table=torch.from_numpy(
            table), cache=cache)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert same is cache


@functools.lru_cache(maxsize=None)
def lean_items():
    """The committed items of the port's lean parse of the batch."""
    bufs, lengths = batch(), torch.tensor(LENGTHS)
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(torch.from_numpy(bufs.copy()),
                                       lengths)
    cost = optimal.literal_costs(bp, lengths,
                                 optimal.literal_cost_table(bp, lengths))
    dc = optimal.dist_cost
    span, dist = kernels.dp_parse_plain(
        cost, lenA, dA, dc(dA), lenB, dB, dc(dB), lenC, dC, dc(dC), d3,
        dc(d3), torch.from_numpy(optimal.SEED_LC_LEN), optimal.DP_SEG)
    cm, cl, eff = optimal.commit(span, dist, pos, lengths, optimal.DP_SEG)
    return bp, cm, cl, eff, dist


@pytest.mark.parametrize("items", ["lean parse", "literals only",
                                   "no items"])
def test_code_lens_from_items(items):
    bp, cm, cl, eff, dist = lean_items()
    if items != "lean parse":
        cl = cl | cm if items == "literals only" else torch.zeros_like(cl)
        cm = torch.zeros_like(cm)
    got = optimal.code_lens_from_items(bp, cm, cl, eff, dist)
    fn = jax.vmap(lambda *a: to._code_lens_from_items(*a, N))
    want = fn(*(jnp.asarray(x.numpy()) for x in (bp, cm, cl)),
              *(jnp.asarray(x.numpy(), jnp.int32) for x in (eff, dist)))
    assert_same(got, want, ["lit_lens", "dist_lens"])


def test_lc_len_from_lens_and_take30():
    rng = np.random.default_rng(9)
    lens = rng.integers(0, 16, (3, 286))
    lens[1, 257:] = 0
    got = optimal.lc_len_from_lens(torch.from_numpy(lens))
    want = jax.vmap(to._lc_len_from_lens)(jnp.asarray(lens, jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))
    table = rng.integers(0, 400, (3, 30))
    idx = rng.integers(0, 32, (3, 5000))
    got = optimal.take30(torch.from_numpy(table), torch.from_numpy(idx))
    want = jax.vmap(to._take30)(jnp.asarray(table, jnp.int32),
                                jnp.asarray(idx, jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))
