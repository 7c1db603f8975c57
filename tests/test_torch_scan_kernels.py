"""C1 and C2, the compress paths' loop kernels, on the CPU.

csrc/commit_fsm.cu (C1, ``scan_kernels.commit_fsm``) and csrc/code_lens.cu
(C2, ``scan_kernels.code_lens``) run only on the card.  This file holds
numpy mirrors of their algorithms (C2's from crafted_scan), step by
step as the CUDA code takes them, against the JAX package's
libdeflate_tpu/compress/tpu_pipeline.py::_greedy_commit_merge and
libdeflate_tpu/compress/tpu_dynamic.py::_build_code_lens, and the plain
versions the wrappers take on the CPU against the same:

- C1: each lane walked in windows of 64 positions: the records (eff of a
  match, minus the run of literals a literal starts, cut at the window's
  end); the chain's steps, one a match or a run of literals, carrying
  (t, pdist, pbud) from window to window and marking a match's head (or
  its absorption) and a run's entry; the flush, where a literal position
  is a head when the last entry mark at or before it lies after the last
  non-literal position at or before it, out from the next head, and one
  pending head a lane.  Inputs: the DP's spans and distances of 64 KiB
  text, records and a 40000-byte chunk (as tests/test_torch_pipeline.py
  makes them), the greedy parser's of the text chunk, a 2500-byte chunk
  committed as one lane of its n_pad, and the crafted segments of
  libdeflate_tpu_torch/experiments/crafted_scan.py at segments of 512,
  1024, 2600 and 4608.
- C2 (the mirror is crafted_scan.code_lens_mirror, whose step counts
  also give chip_smoke.py's chain bound): one row a warp: the seed's two
  f32 operations, the used symbols sorted by (hist descending, index
  ascending) into 32 J slots, the spend as a scan under "no clamp"
  corrected clamp by clamp until s <= 1, the fix steps as reductions of k << 9 | index keys with index 0 for an
  empty halving set, and the refinement's passes: A and B of every length
  at once (the smallest p and the largest p2), the level steps as a chain
  of scalars over the lengths present, B carried from the step before;
  the early stops (a fix step of delta 0, r <= 0, a refinement pass that
  changes nothing).  Inputs: crafted_scan's histograms (286, 30 and 512
  symbols; nine rows; counts past 2^21) and the lean path's own (the DP's
  commit of the text and records chunks), at (refine 0, 11 bits) and
  (refine 16, 15 bits).

The kernels themselves are held against the plain versions on the card
by chip_smoke.py on the same sets.  Tolerance: exact.
"""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import (dynamic, kernels, optimal,
                                           pipeline, scan_kernels)
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

C1_WINDOW = 64      # commit_fsm.cu's kW


def commit_mirror(span, is_match, dist, seg, seen=None):
    """csrc/commit_fsm.cu's lanes on flat numpy arrays: (heads, out).
    Each lane is walked in windows of C1_WINDOW positions: the records
    (eff of a match, minus the literal run it starts, cut at the window's
    end), the chain's steps carrying (t, pdist, pbud) from window to
    window and marking a match's head 1 (absorbed 0) and a run's entry 2,
    then the flush: a literal position is a head when the last entry mark
    at or before it lies after the last non-literal position at or before
    it; out from the next head, with one pending head a lane.  ``seen``
    collects the names of the window crossings taken."""
    seen = set() if seen is None else seen
    span, is_match, dist = (np.asarray(a).reshape(-1)
                            for a in (span, is_match, dist))
    heads = np.full(span.shape, 2, np.int64)     # 2: never written
    out = np.full(span.shape, -1, np.int64)
    W = C1_WINDOW
    for base in range(0, span.size, seg):
        t, pdist, pbud, run_window, pend = 0, 0, 0, -1, -1
        for wbeg in range(0, seg, W):
            wend = min(wbeg + W, seg)
            tt = np.arange(wbeg, wend)
            trunc = np.minimum(span[base + tt], seg - tt)
            m = is_match[base + tt] & (trunc >= 3)
            eff = np.where(m, trunc, 1)
            rec = np.empty(tt.size, np.int64)
            nxt = tt.size                         # the run's end
            for off in range(tt.size - 1, -1, -1):
                if m[off]:
                    nxt = off
                    rec[off] = eff[off]
                else:
                    rec[off] = -(nxt - off)
            mark = np.zeros(tt.size, np.int64)
            while t < wend:                       # the chain
                off = t - wbeg
                r = int(rec[off])
                dd = int(dist[base + t])
                lit = r < 0
                absorb = (not lit and pdist == dd and pdist > 0
                          and r <= MAX_LEN - pbud)
                mark[off] = 2 if lit else (0 if absorb else 1)
                if absorb:
                    pbud += r
                    if run_window != wbeg:
                        seen.add("run absorbed across windows")
                else:
                    pdist, pbud = (0, 0) if lit else (dd, r)
                    run_window = wbeg
                t += -r if lit else r
                if lit and t == wend < seg and not (
                        is_match[base + t]
                        and min(int(span[base + t]), seg - t) >= 3):
                    seen.add("literal run cut at the window end")
                if not lit and t > wend:
                    seen.add("jump past the window end")
            # the flush: literal heads from the entry marks
            head = np.zeros(tt.size, np.int64)
            last_entry = last_sep = -1
            for off in range(tt.size):
                if mark[off] == 2:
                    last_entry = off
                if rec[off] >= 0:
                    last_sep = off
                head[off] = mark[off] == 1 or (
                    rec[off] < 0 and last_entry > last_sep)
            hpos = np.flatnonzero(head)           # the window's heads
            if hpos.size:
                if pend >= 0:
                    out[base + pend] = wbeg + hpos[0] - pend
                    if hpos[0] > 0:
                        seen.add("pending head across windows")
                out[base + wbeg + hpos[:-1]] = np.diff(hpos)
                pend = wbeg + int(hpos[-1])
            else:
                seen.add("window without a head")
            nonhead = head == 0
            out[base + tt[nonhead]] = eff[nonhead]
            heads[base + tt] = head
        out[base + pend] = seg - pend
    assert (heads < 2).all(), "a position no window wrote"
    assert (out >= 0).all(), "a head left pending"
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


@pytest.mark.parametrize("name", list(cs.commit_long_sets()))
def test_commit_mirror_long_segments(name):
    """Segments of 2600 (not a multiple of the kernel's window) and 4608
    positions."""
    span, is_match, dist, seg = cs.commit_long_sets()[name]
    assert check_commit(span, is_match, dist, seg) > 0


def test_commit_mirror_one_lane_a_chunk():
    """A 2500-byte chunk's lean DP spans committed as one lane of its
    whole n_pad (2560), as the DP tiers commit a chunk whose n_pad is not
    a multiple of DP_SEG."""
    n = 2500
    b = torch.from_numpy(text_chunk(n).copy())[None]
    lt = torch.tensor([n])
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(b, lt)
    n_pad = bp.shape[1]
    assert n_pad == 2560 and n_pad % optimal.DP_SEG
    cost = optimal.literal_costs(bp, lt, optimal.literal_cost_table(bp, lt))
    span, dist = kernels.dp_parse(
        cost, lenA, dA, optimal.dist_cost(dA), lenB, dB,
        optimal.dist_cost(dB), lenC, dC, optimal.dist_cost(dC), d3,
        optimal.dist_cost(d3), torch.from_numpy(optimal.SEED_LC_LEN), n_pad)
    is_match = (span >= 3) & (dist > 0)
    check_commit(span.numpy(), is_match.numpy(), dist.numpy(), n_pad)


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


def test_commit_window_crossings_are_reached():
    """Between them the crafted sets cross the kernel's windows in every
    way: a jump past a window's end, a literal run cut at a window's end
    and resumed in the next, a run of one distance absorbing a match in a
    later window than its head, a pending head ended by a later window's
    first head, and a window a match covers whole (no head)."""
    seen = set()
    for span, is_match, dist in cs.commit_sets().values():
        for seg in cs.COMMIT_SEGS:
            commit_mirror(span, is_match, dist, seg, seen)
    for span, is_match, dist, seg in cs.commit_long_sets().values():
        commit_mirror(span, is_match, dist, seg, seen)
    assert seen == {"jump past the window end",
                    "literal run cut at the window end",
                    "run absorbed across windows",
                    "pending head across windows", "window without a head"}
    # and the long sets' truncated matches cross the last window's start
    span, is_match, dist, seg = cs.commit_long_sets()[
        "matches truncated at the segment end, seg 2600"]
    heads, out = commit_mirror(span, is_match, dist, seg)
    last_w = (seg - 1) // C1_WINDOW * C1_WINDOW
    t = last_w - 10
    assert out[t] == seg - t and t + out[t] > last_w and not heads[t]


# ---- C2: the code-length build -----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_code_lens(refine, max_len, nsym=td.NSYM):
    return jax.jit(jax.vmap(functools.partial(
        td._build_code_lens, nsym=nsym, refine_passes=refine,
        max_len=max_len)))


def check_code_lens(hist, refine, max_len):
    """Mirror, plain version (through the CPU wrapper) and JAX, row by
    row; returns the branches the mirror took."""
    wl, wo = _jax_code_lens(refine, max_len, hist.shape[1])(
        jnp.asarray(hist, jnp.int32))
    wl, wo = np.asarray(wl), np.asarray(wo)
    scan_kernels.reset_launch_counts()
    gl, go = scan_kernels.code_lens(torch.from_numpy(hist), refine, max_len)
    assert scan_kernels.code_lens.launches == 0
    seen = Counter()
    for r in range(hist.shape[0]):
        ml, mo = cs.code_lens_mirror(hist[r], refine, max_len, seen)
        assert np.array_equal(ml, wl[r]) and mo == bool(wo[r]), r
    assert np.array_equal(gl.numpy(), wl)
    assert np.array_equal(go.numpy(), wo)
    return seen


@pytest.mark.parametrize("cfg", cs.CODE_LENS_CFGS)
@pytest.mark.parametrize("name", list(cs.hist_sets()))
def test_code_lens_mirror_crafted(name, cfg):
    check_code_lens(cs.hist_sets()[name], *cfg)


@pytest.mark.parametrize("cfg", cs.CODE_LENS_CFGS)
@pytest.mark.parametrize("name", list(cs.hist_sets_other()))
def test_code_lens_mirror_other_shapes(name, cfg):
    """Rows of 30 and 512 symbols, and nine rows (three of the kernel's
    four-row blocks)."""
    check_code_lens(cs.hist_sets_other()[name], *cfg)


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
    seen = Counter()
    for hist in cs.hist_sets().values():
        for cfg in cs.CODE_LENS_CFGS:
            for row in hist:
                cs.code_lens_mirror(row, *cfg, seen)
    assert set(seen) == {
        "bump", "bump of share 0", "double", "halve an empty set",
        "fix fixed point", "refine move", "refine fixed point",
        "spend clamp", "spend at s = 1", "level step", "skipped level",
        "B carried from the step before", "up through two levels"}


@pytest.mark.parametrize("kind", range(5))
def test_soak_payload_is_the_soak_scripts(kind):
    """crafted_scan.soak_payload, the port's copy of
    scripts/tpu_soak.py's gen_payload, draws the same bytes."""
    from scripts import tpu_soak
    for n in (1, 777, 5000):
        assert cs.soak_payload(np.random.default_rng(kind), kind, n) == \
            tpu_soak.gen_payload(np.random.default_rng(kind), kind, n)


@pytest.mark.parametrize("cfg", cs.CODE_LENS_CFGS)
def test_code_lens_chain_counts_the_kernels_steps(cfg):
    """crafted_scan.code_lens_chain, C2's chain in chip_smoke.py's bound:
    its clamps are the reference's sequential spend's (a k below its
    k_des, up to the first that leaves budget - later at 1, after which
    every k is 1), and on rows counted by hand its
    steps are the scan's 5 + J, 5 a clamp, fix step and pass, 1 a level
    step."""
    refine, max_len = cfg
    kraft = 1 << max_len
    for hist in list(cs.hist_sets().values()) + \
            list(cs.hist_sets_other().values()):
        chain = cs.code_lens_chain(hist, *cfg)
        for row, c in zip(hist, chain):
            used = np.flatnonzero(row > 0)
            order = used[np.lexsort((used, -row[used]))]
            scale = np.float32(kraft) / np.float32(max(int(row.sum()), 1))
            share = (row.astype(np.float32) * scale).astype(np.uint32)
            budget, clamps, at_one = kraft, 0, False
            for j, i in enumerate(order):
                sh = int(share[i])
                e = cs.bsr(max(sh, 1))
                e += (sh - (1 << e)) & 0xFFFFFFFF > 1 << max(e - 1, 0)
                k_des = 1 << min(e, max_len - 1)
                s = budget - (len(order) - 1 - j)
                k = 1 << cs.bsr(min(k_des, max(s, 1)))
                if k < k_des and not at_one:
                    clamps += 1
                    at_one = s + 1 - k <= 1
                budget -= k
            assert c["clamps"] == clamps
            assert c["steps"] == c["scan"] + c["levels"] + 5 * (
                c["clamps"] + c["fix"] + c["passes"])
    # equal pair: k = kraft / 2 each, r = 0; a refinement pass finds
    # only length 1 and stops
    even = cs.code_lens_chain(cs._row([(256, 5), (1, 5)])[None], *cfg)[0]
    assert even == {"scan": 6, "clamps": 0, "fix": 0,
                    "passes": 1 if refine else 0, "levels": 0,
                    "steps": 11 if refine else 6}
    # 1000 and 1: k 1024 and 2 at 11 bits, then nine doublings of the 2
    if max_len == 11:
        skew = cs.code_lens_chain(cs._row([(3, 1000), (200, 1)])[None],
                                  *cfg)[0]
        assert (skew["clamps"], skew["fix"], skew["steps"]) == (0, 9, 51)
