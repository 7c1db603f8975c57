"""C1 and C2, the compress paths' loop kernels, on the CPU.

csrc/commit_fsm.cu (C1, ``scan_kernels.commit_fsm``) and csrc/code_lens.cu
(C2, ``scan_kernels.code_lens``) run only on the card.  This file holds
numpy mirrors of their algorithms, step by step as the CUDA code takes
them, against the JAX package's
libdeflate_tpu/compress/tpu_pipeline.py::_greedy_commit_merge and
libdeflate_tpu/compress/tpu_dynamic.py::_build_code_lens, and the plain
versions the wrappers take on the CPU against the same:

- C1: one lane a segment; forward, the jump from one commit to the next
  carrying (pdist, pbud), with heads written over every position a commit
  covers; backward, the sweep that holds the next head after t.  Inputs:
  the DP's spans and distances of 64 KiB text, records and a 40000-byte
  chunk (as tests/test_torch_pipeline.py makes them), the greedy parser's
  of the text chunk, and the crafted segments of
  libdeflate_tpu_torch/experiments/crafted_scan.py, at segments of 512
  and 1024.
- C2: one row a block; the seed's two f32 operations, the rank-count
  order, the spend over ranks with n_used - 1 - j later symbols, the fix
  and level steps as reductions of (value, index) keys with the first
  index on ties, index 0 for an empty halving set, and the early stops
  (a fix step of delta 0, r <= 0, a refinement pass that changes
  nothing).  Inputs: crafted_scan's histograms and the lean path's own
  (the DP's commit of the text and records chunks), at (refine 0, 11
  bits) and (refine 16, 15 bits).

The kernels themselves are held against the plain versions on the card
by chip_smoke.py on the same sets.  Tolerance: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import (dynamic, optimal, pipeline,
                                           scan_kernels)
from libdeflate_tpu_torch.compress.bits import length_slot, offset_slot
from libdeflate_tpu_torch.experiments import crafted_scan as cs

from test_torch_pipeline import port_parse, text_chunk

MAX_LEN = 258


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- C1: the commit FSM ------------------------------------------------

def commit_mirror(span, is_match, dist, seg):
    """csrc/commit_fsm.cu's lanes on flat numpy arrays: (heads, out)."""
    span, is_match, dist = (np.asarray(a).reshape(-1)
                            for a in (span, is_match, dist))
    heads = np.full(span.shape, 2, np.int64)     # 2: never written
    out = np.zeros(span.shape, np.int64)

    def step_eff(t, rem):
        trunc = min(int(span[t]), rem)
        m = bool(is_match[t]) and trunc >= 3
        return (trunc if m else 1), m

    for base in range(0, span.size, seg):
        pdist = pbud = 0
        t = 0
        while t < seg:                       # from commit to commit
            e, m = step_eff(base + t, seg - t)
            dd = int(dist[base + t])
            absorb = m and pdist == dd and pdist > 0 and pbud + e <= MAX_LEN
            if absorb:
                pbud += e
            else:
                pdist, pbud = (dd, e) if m else (0, 0)
            heads[base + t] = 0 if absorb else 1
            heads[base + t + 1:base + t + e] = 0
            t += e
        nxt = seg
        for t in range(seg - 1, -1, -1):     # the next head after t
            e, _ = step_eff(base + t, seg - t)
            h = heads[base + t]
            assert h in (0, 1), "a position no commit covered"
            out[base + t] = nxt - t if h else e
            if h:
                nxt = t
    return heads.astype(bool), out


@functools.lru_cache(maxsize=None)
def _jax_commit(seg):
    return jax.jit(functools.partial(tp._greedy_commit_merge, seg=seg))


def check_commit(span, is_match, dist, seg):
    """Mirror, plain version (through the CPU wrapper) and JAX, row by
    row; returns the number of heads."""
    B = span.shape[0]
    scan_kernels.reset_launch_counts()
    got = scan_kernels.commit_fsm(torch.from_numpy(span),
                                  torch.from_numpy(is_match),
                                  torch.from_numpy(dist), seg)
    assert scan_kernels.commit_fsm.launches == 0
    mh, mo = commit_mirror(span, is_match, dist, seg)
    mh, mo = mh.reshape(B, -1), mo.reshape(B, -1)
    for b in range(B):
        wh, wo = _jax_commit(seg)(jnp.asarray(span[b], jnp.int32),
                                  jnp.asarray(is_match[b]),
                                  jnp.asarray(dist[b], jnp.int32))
        wh, wo = np.asarray(wh), np.asarray(wo)
        assert np.array_equal(mh[b], wh) and np.array_equal(mo[b], wo)
        assert np.array_equal(got[0][b].numpy(), wh)
        assert np.array_equal(got[1][b].numpy(), wo)
    return int(mh.sum())


@pytest.mark.parametrize("seg", cs.COMMIT_SEGS)
@pytest.mark.parametrize("name", list(cs.commit_sets()))
def test_commit_mirror_crafted(name, seg):
    span, is_match, dist = cs.commit_sets()[name]
    heads = check_commit(span, is_match, dist, seg)
    assert heads > 0


@pytest.mark.parametrize("seg", cs.COMMIT_SEGS)
@pytest.mark.parametrize("kind", ["text", "records", "text_short"])
def test_commit_mirror_dp_spans(kind, seg):
    _, _, span, dist, _ = port_parse(kind)
    is_match = (span >= 3) & (dist > 0)
    check_commit(span.numpy(), is_match.numpy(), dist.numpy(), seg)


def test_commit_mirror_greedy_spans():
    n = 1 << 16
    b = torch.from_numpy(text_chunk(n).copy())[None]
    _, _, span, is_match, dist, seg = pipeline.greedy_candidates(
        b, torch.tensor([n]))
    assert seg == 512
    check_commit(span.numpy(), is_match.numpy(), dist.numpy(), seg)


def test_commit_crafted_edges_are_reached():
    """The crafted sets reach the edges they are named for: a run held
    at the 258 cap, 1- and 2-byte truncations at a segment end that
    become literals, and dist-0 matches that never merge."""
    sets = cs.commit_sets()
    span, is_match, dist = sets["same-distance chains about the 258 cap"]
    heads, out = commit_mirror(span, is_match, dist, 512)
    assert out[heads].max() == MAX_LEN
    span, is_match, dist = sets["matches truncated at the segment end"]
    heads, out = commit_mirror(span, is_match, dist, 512)
    for k, end in enumerate(range(512, span.size + 1, 512)):
        back = 1 + (k % (cs.COMMIT_N // 512)) % 3
        assert heads[end - back]
        assert out[end - back] == (1 if back < 3 else 3)
    span, is_match, dist = sets["is_match with dist 0"]
    heads, out = commit_mirror(span, is_match, dist, 512)
    span, dist = span.reshape(-1), dist.reshape(-1)
    trunc = np.minimum(span, 512 - np.arange(span.size) % 512)
    zero = heads & (dist == 0) & is_match.reshape(-1) & (trunc >= 3)
    assert zero.any() and (out[zero] == trunc[zero]).all()


# ---- C2: the code-length build -----------------------------------------

def bsr(x: int) -> int:
    return int(x).bit_length() - 1


def code_lens_mirror(hist, refine_passes, max_len, seen=None):
    """csrc/code_lens.cu's block on one numpy row: (lens, ok).  ``seen``
    collects the names of the branches taken."""
    seen = set() if seen is None else seen
    h = np.asarray(hist, np.int64)
    nsym = h.size
    i = np.arange(nsym)
    used = h > 0
    kraft = 1 << max_len
    n_used = int(used.sum())
    total = max(int(h.sum()), 1)

    # the seed: two correctly rounded f32 operations
    scale = np.float32(kraft) / np.float32(total)
    share = (h.astype(np.float32) * scale).astype(np.uint32)
    k_des = np.zeros(nsym, np.int64)
    for s in range(nsym):
        sh = int(share[s])
        e = bsr(max(sh, 1))
        half = 1 << max(e - 1, 0)
        if (sh - (1 << e)) & 0xFFFFFFFF > half:
            e += 1
            seen.add("bump" if sh else "bump of share 0")
        if used[s]:
            k_des[s] = 1 << min(max(e, 0), max_len - 1)

    # the rank count over unique keys, then the spend over ranks
    key = h * 512 + (nsym - i)
    rank = (key[None, :] > key[:, None]).sum(1)
    assert sorted(rank) == list(range(nsym))
    assert (rank[used] < n_used).all()
    ksort = np.zeros(nsym, np.int64)
    ksort[rank] = k_des
    budget = kraft
    for j in range(n_used):
        allow = max(budget - (n_used - 1 - j), 1)
        kj = 1 << bsr(min(int(ksort[j]), allow))
        budget -= kj
        ksort[j] = kj
    k = np.where(used, ksort[rank], 0)

    # the fix steps, each a reduction of (value, index) keys
    r = kraft - int(k.sum())
    for _ in range(48):
        if r <= 0:
            break
        can_dbl = used & (k <= r) & (k < (kraft >> 1))
        can_hlv = used & (k > r) & (k >= 2)
        dkey = np.where(can_dbl, (k << 10) | (1023 - i), -1).max()
        hkey = np.where(can_hlv, k, 1 << 30) << 10 | i
        hkey = hkey.min()
        if dkey >= 0:
            idx, kidx = 1023 - (dkey & 1023), dkey >> 10
            delta = kidx
            seen.add("double")
        else:
            idx = hkey & 1023
            kidx = k[0] if hkey >> 10 == 1 << 30 else hkey >> 10
            delta = -(kidx >> 1)
            seen.add("halve" if hkey >> 10 != 1 << 30 else
                     "halve an empty set")
        if delta == 0:
            seen.add("fix fixed point")
            break
        k[idx] += delta
        r -= int(delta)
    lens = np.where(k > 0, max_len - np.array([bsr(max(x, 1)) for x in k]),
                    0)

    # the refinement's level steps
    for _ in range(refine_passes):
        changed = False
        for ln in range(2, max_len + 1):
            akey = np.where(used & (lens == ln), (h << 10) | (1023 - i),
                            -1).max()
            bkey = np.where(used & (lens == ln - 1), (h << 10) | i,
                            np.iinfo(np.int64).max).min()
            if akey >= 0 and bkey != np.iinfo(np.int64).max \
                    and (akey >> 10) > (bkey >> 10):
                lens[1023 - (akey & 1023)] -= 1
                lens[bkey & 1023] += 1
                changed = True
                seen.add("refine move")
        if not changed:
            seen.add("refine fixed point")
            break
    return lens, r == 0 and n_used >= 2


@functools.lru_cache(maxsize=None)
def _jax_code_lens(refine, max_len):
    return jax.jit(jax.vmap(functools.partial(
        td._build_code_lens, nsym=td.NSYM, refine_passes=refine,
        max_len=max_len)))


def check_code_lens(hist, refine, max_len):
    """Mirror, plain version (through the CPU wrapper) and JAX, row by
    row; returns the branches the mirror took."""
    wl, wo = _jax_code_lens(refine, max_len)(jnp.asarray(hist, jnp.int32))
    wl, wo = np.asarray(wl), np.asarray(wo)
    scan_kernels.reset_launch_counts()
    gl, go = scan_kernels.code_lens(torch.from_numpy(hist), refine, max_len)
    assert scan_kernels.code_lens.launches == 0
    seen = set()
    for r in range(hist.shape[0]):
        ml, mo = code_lens_mirror(hist[r], refine, max_len, seen)
        assert np.array_equal(ml, wl[r]) and mo == bool(wo[r]), r
    assert np.array_equal(gl.numpy(), wl)
    assert np.array_equal(go.numpy(), wo)
    return seen


@pytest.mark.parametrize("cfg", cs.CODE_LENS_CFGS)
@pytest.mark.parametrize("name", list(cs.hist_sets()))
def test_code_lens_mirror_crafted(name, cfg):
    check_code_lens(cs.hist_sets()[name], *cfg)


@pytest.mark.parametrize("cfg", cs.CODE_LENS_CFGS)
@pytest.mark.parametrize("kind", ["text", "records"])
def test_code_lens_mirror_lean_histograms(kind, cfg):
    """The rows build_code_lens_pair gets from the lean path's commit."""
    bp, pos, span, dist, lt = port_parse(kind)
    cm, cl, eff = optimal.commit(span, dist, pos, lt, optimal.DP_SEG)
    lslot = length_slot(torch.clamp(eff, min=3))[0]
    oslot = offset_slot(torch.clamp(dist, min=1))[0]
    hl, hd = dynamic.code_hists(dynamic.item_sym(bp, cm, cl, oslot, lslot))
    h = torch.stack([hl, torch.nn.functional.pad(hd, (0, cs.NSYM - cs.NDIST))],
                    1).reshape(-1, cs.NSYM)
    check_code_lens(h.numpy(), *cfg)


def test_code_lens_crafted_branches_are_reached():
    """Between them the crafted sets take every branch of the kernel that
    an input can reach: a bump, the bump of a zero share, doubling,
    halving (an empty set: index 0), a fix step that stops at delta 0,
    refinement moves and the refinement's fixed point.  Halving a
    candidate cannot happen (crafted_scan.hist_sets says why), and the
    mirror never takes it."""
    seen = set()
    for hist in cs.hist_sets().values():
        for cfg in cs.CODE_LENS_CFGS:
            for row in hist:
                code_lens_mirror(row, *cfg, seen)
    assert seen == {"bump", "bump of share 0", "double", "halve an empty set",
                    "fix fixed point", "refine move", "refine fixed point"}
