"""The port's dynamic-Huffman emit against the JAX package's.

libdeflate_tpu_torch/compress/dynamic.py, with scan_kernels.py's
build_code_lens, against libdeflate_tpu/compress/tpu_dynamic.py:
_emit_dynamic_pre's (val, nb, offs) and aux, and _emit_dynamic_post, on the commit arrays the JAX lean
parse (_parse_candidates, _literal_costs with sample 32, _dp_parse on the
dense ladder, _commit) produces for 64 KiB chunks of text, noisy records,
all zeros (a tiny code) and random bytes (the static block type); plus
the code-length build, canonical tables, histogram and RLE header on
numpy-seeded inputs.  Tolerance: exact.
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
from libdeflate_tpu_torch.compress import dynamic, scan_kernels

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16
LEAN = dict(depth=6, two_pass=False, hash3=False, wide_window=True,
            use_content=False, use_wide=False, ext_c=False, lcp=16,
            strides2=())


def _chunks():
    rng = np.random.default_rng(21)
    raw = (REPO / "SURVEY.md").read_bytes()
    text = np.frombuffer((raw * (N // len(raw) + 1))[:N], np.uint8)
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), N // 64)
    rec = np.where(rng.random(N) < 0.05, rng.integers(0, 256, N), rec)
    return {
        "text": (text, N),
        "records": (rec.astype(np.uint8), N),
        "zeros": (np.zeros(N, np.uint8), N),
        "random": (rng.integers(0, 256, N, dtype=np.uint8), N),
        "text_short": (text, 40000),
    }


CHUNKS = _chunks()


@jax.jit
def _jax_lean_parse(b, length):
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = tp._parse_candidates(
        b, length, **LEAN)
    cost_lit, _ = to._literal_costs(bp, length, bp.shape[0], sample=32)
    dc = to._dist_cost
    span, dist = to._dp_parse(
        cost_lit, lenA, dA, dc(dA), lenB, dB, dc(dB), lenC, dC, dc(dC),
        d3, dc(d3), jnp.asarray(to._SEED_LC_LEN), to.DP_SEG,
        ladder=to.LEN_LADDER_DENSE2)
    cm, cl, eff = to._commit(span, dist, pos, length, to.DP_SEG)
    return bp, cm, cl, eff, dist


_jax_pre = jax.jit(functools.partial(td._emit_dynamic_pre, n_pad=N,
                                     refine_passes=0))


@functools.lru_cache(maxsize=None)
def jax_commit(kind):
    b, length = CHUNKS[kind]
    return [np.asarray(x) for x in _jax_lean_parse(jnp.asarray(b),
                                                    jnp.int32(length))]


def _t(x):
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x)[None]


def _same(got, want):
    return np.array_equal(got[0].numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("kind", list(CHUNKS))
def test_emit_dynamic_pre(kind):
    arrs = jax_commit(kind)
    (val_j, nb_j, offs_j), aux_j = _jax_pre(*[jnp.asarray(a) for a in arrs])
    (val, nb, offs), aux = dynamic.emit_dynamic_pre(*[_t(a) for a in arrs])
    assert _same(val, val_j)
    assert _same(nb, nb_j)
    assert _same(offs, offs_j)
    for name, g, w in zip("hdr44 eob_code eob_len hdr_bits body_bits".split(),
                          aux, aux_j):
        assert np.array_equal(g[0].numpy(), np.asarray(w).astype(np.int64)), \
            name


@pytest.mark.parametrize("kind", list(CHUNKS))
@pytest.mark.parametrize("bfinal", [False, True])
def test_emit_dynamic_post(kind, bfinal):
    arrs = jax_commit(kind)
    (val, nb, offs), aux = _jax_pre(*[jnp.asarray(a) for a in arrs])
    sbuf, gw = tp._group_premerge(val, nb, offs, capw=td.DYN_CAPW)
    words = tp._group_place(sbuf, gw, td._dyn_nwords(N))
    w_j, t_j = td._emit_dynamic_post(words, aux, jnp.asarray(bfinal))
    w, t = dynamic.emit_dynamic_post(
        _t(words), [_t(a) for a in aux], torch.tensor([bfinal]))
    assert _same(w, w_j)
    assert int(t[0]) == int(t_j)


def test_emit_dynamic_post_drops_words_past_the_end():
    """mode="drop": tail words beyond the buffer vanish, never clamp."""
    nwords = 60
    words = np.zeros(nwords, np.uint32)
    aux = (np.zeros(44, np.uint32), np.uint32(0x5), np.int32(3),
           np.int32(3), np.int32(32 * nwords - 8))
    w_j, t_j = td._emit_dynamic_post(jnp.asarray(words),
                                     tuple(jnp.asarray(a) for a in aux),
                                     jnp.asarray(True))
    w, t = dynamic.emit_dynamic_post(_t(words), [_t(a) for a in aux],
                                     torch.tensor([True]))
    assert _same(w, w_j)
    assert int(t[0]) == int(t_j)


def _hists():
    rng = np.random.default_rng(6)
    out = []
    for alpha in (0.02, 0.3, 3.0):
        p = rng.dirichlet(np.ones(td.NSYM) * alpha)
        out.append(rng.multinomial(int(rng.integers(10, 1 << 20)), p))
    one = np.zeros(td.NSYM, np.int64)
    one[65] = 1000
    two = one.copy()
    two[256] = 1
    flat = np.ones(td.NSYM, np.int64)
    return out + [one, two, flat]


@pytest.mark.parametrize("idx", range(6))
def test_build_code_lens(idx):
    hist = _hists()[idx]
    lens_j, ok_j = td._build_code_lens(jnp.asarray(hist, jnp.int32), td.NSYM)
    lens, ok = scan_kernels.build_code_lens(torch.from_numpy(hist)[None])
    assert np.array_equal(lens[0].numpy(), np.asarray(lens_j))
    assert bool(ok[0]) == bool(ok_j)


def test_build_code_lens_pair_and_canonical_tables():
    rng = np.random.default_rng(8)
    hl = np.stack([rng.multinomial(50000, rng.dirichlet(np.ones(td.NSYM)))
                   for _ in range(3)])
    hd = np.stack([rng.multinomial(9000, rng.dirichlet(np.ones(td.NDIST)))
                   for _ in range(3)])
    lit, dist, okl, okd = dynamic.build_code_lens_pair(
        torch.from_numpy(hl), torch.from_numpy(hd))
    t_lit = dynamic.canonical_table(lit)
    t_dist = dynamic.canonical_table(dist)
    for k in range(3):
        lj, dj, oklj, okdj = td._build_code_lens_pair(
            jnp.asarray(hl[k], jnp.int32), jnp.asarray(hd[k], jnp.int32))
        assert np.array_equal(lit[k].numpy(), np.asarray(lj))
        assert np.array_equal(dist[k].numpy(), np.asarray(dj))
        assert (bool(okl[k]), bool(okd[k])) == (bool(oklj), bool(okdj))
        assert np.array_equal(t_lit[k].numpy(),
                              np.asarray(td._canonical_table(lj, td.NSYM)))
        assert np.array_equal(t_dist[k].numpy(),
                              np.asarray(td._canonical_table(dj, td.NDIST)))


def test_histogram():
    rng = np.random.default_rng(12)
    sym = rng.integers(0, td.NSYM_ALL + 1, (3, 1 << 14))
    got = dynamic.batched_hist(torch.from_numpy(sym), td.NSYM_ALL)
    for k in range(3):
        want = td._hist_matmul(jnp.asarray(sym[k], jnp.int32), td.NSYM_ALL)
        assert np.array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_precode_rle(seed):
    rng = np.random.default_rng(seed)
    # code-length vectors with long zero runs and repeats
    lens = np.repeat(rng.integers(0, 12, 60), rng.integers(1, 40, 60))
    lens = np.resize(lens, td.NSYM_ALL).astype(np.int32)
    v_j, b_j, tot_j = td._precode_rle_items(jnp.asarray(lens), 29, 29)
    v, b, tot = dynamic.precode_rle_items(torch.from_numpy(lens)[None])
    assert _same(v, v_j)
    assert _same(b, b_j)
    assert int(tot[0]) == int(tot_j)
    w_j, _ = td._precode_rle_header(jnp.asarray(lens), 29, 29)
    w, _ = dynamic.precode_rle_header(torch.from_numpy(lens)[None])
    if int(tot_j) < td.HDR_BITS:      # the only case the words are used
        assert np.array_equal(w[0, :44].numpy(),
                              np.asarray(w_j)[:44].astype(np.int64))


def test_dyn_nwords():
    for n in (1, 128, 40000, 1 << 16, 1 << 20):
        assert dynamic.dyn_nwords(n) == td._dyn_nwords(n)
