"""The compress paths' two loop kernels: wrappers, plain versions,
launch counts.

They replace XLA loop code (``lax.scan``s), not Pallas kernels:

- ``commit_fsm`` replaces ``_greedy_commit_merge``
  (``libdeflate_tpu/compress/tpu_pipeline.py:771-826``, its scan at
  ``:809``), the commit FSM with same-distance merging; kernel
  ``csrc/commit_fsm.cu``, plain version ``greedy_commit_merge``.
- ``code_lens`` replaces ``_build_code_lens``
  (``libdeflate_tpu/compress/tpu_dynamic.py:140-262``: the spend, fix and
  refinement scans), one histogram row a block; kernel
  ``csrc/code_lens.cu``, plain version ``build_code_lens``, which keeps
  the scans as loops over the symbols and levels, batched over rows.

A wrapper given CUDA tensors launches its kernel or raises; it takes the
plain version only for tensors on the CPU.  Each wrapper counts its
kernel launches in its ``launches`` attribute and launches through
``_build.launch_context``, as ``kernels.py``'s do.
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import M32, MAX_LEN, bsr
from .kernels import _check, _ptr

MAX_CODE_LEN = 11           # the code lengths' cap without refinement
CODE_LENS_MAX_SYM = 512     # the rank order's keys hist * 512 + nsym - i
CODE_LENS_MAX_LEN = 15


def reset_launch_counts() -> None:
    commit_fsm.launches = 0
    code_lens.launches = 0


def greedy_commit_merge(span, is_match, dist, seg: int):
    """Commit FSM with same-distance run coalescing
    (``_greedy_commit_merge``) over independent ``seg``-position
    segments of [B, n] arrays.  Returns (committed heads, merged eff)."""
    shape = span.shape
    lanes = span.numel() // seg
    dev = span.device

    def steps(x):
        return x.reshape(lanes, seg).T

    rem = torch.arange(seg, 0, -1, device=dev, dtype=torch.int64)[:, None]
    trunc = torch.minimum(steps(span).to(torch.int64), rem)
    is_m = steps(is_match) & (trunc >= 3)
    effs = torch.where(is_m, trunc, 1)
    dd_t = steps(dist).to(torch.int64)
    # the FSM itself: only (e, pdist, pbud) carry from step to step
    e = torch.zeros(lanes, dtype=torch.int64, device=dev)
    pdist = torch.zeros_like(e)
    pbud = torch.zeros_like(e)
    heads = torch.empty(seg, lanes, dtype=torch.bool, device=dev)
    for t in range(seg):
        eff, im, dd = effs[t], is_m[t], dd_t[t]
        commit = e == 0
        absorb = (commit & im & (pdist == dd) & (pdist > 0)
                  & (pbud + eff <= MAX_LEN))
        pdist = torch.where(commit & ~absorb, torch.where(im, dd, 0), pdist)
        pbud = torch.where(commit, torch.where(
            absorb, pbud + eff, torch.where(im, eff, 0)), pbud)
        e = torch.where(commit, eff, e) - 1
        heads[t] = commit & ~absorb
    # merged span at each head = next head strictly after t, minus t
    tix = torch.arange(seg, device=dev, dtype=torch.int64)[:, None]
    x = torch.where(heads, tix, seg)
    x = torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])
    nb_after = torch.cat([x[1:], torch.full_like(x[:1], seg)], 0)
    eff_m = torch.where(heads, nb_after - tix, effs)
    return heads.T.reshape(shape), eff_m.T.reshape(shape)


def commit_fsm_into(span, is_match, dist, seg: int, heads: torch.Tensor,
                    eff: torch.Tensor) -> None:
    """The bare launch of the commit kernel on CUDA tensors: span and dist
    contiguous int64, is_match contiguous bool, heads bool and eff int64,
    all of one shape whose element count is a multiple of seg; every
    element of heads and eff is written.  Counts nothing: ``commit_fsm``
    is the wrapper."""
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("commit_fsm", "commit_fsm_launch",
                       [P, P, P, P, P, I, I, P])
    with _build.launch_context((span, is_match, dist, heads, eff),
                               "commit_fsm") as stream:
        _check(fn(_ptr(span), _ptr(is_match), _ptr(dist), _ptr(heads),
                  _ptr(eff), seg, span.numel() // seg, stream), "commit_fsm")


def commit_fsm(span: torch.Tensor, is_match: torch.Tensor,
               dist: torch.Tensor, seg: int):
    """Commit FSM with same-distance merging (``_greedy_commit_merge``)
    over independent ``seg``-position segments of [B, n] arrays ->
    (heads bool, merged eff int64), shaped as span.  CUDA kernel for CUDA
    tensors (contiguous int64 span and dist and bool is_match, read as
    they are: the wrapper allocates the outputs and launches, nothing
    else), the plain version (``greedy_commit_merge``) for CPU tensors."""
    if is_match.shape != span.shape or dist.shape != span.shape \
            or seg <= 0 or span.numel() % seg:
        raise ValueError("commit_fsm: span, is_match and dist must share "
                         "one shape whose size is a multiple of seg")
    if span.device.type == "cpu":
        return greedy_commit_merge(span, is_match, dist, seg)
    if span.dtype != torch.int64 or dist.dtype != torch.int64 \
            or is_match.dtype != torch.bool \
            or not (span.is_contiguous() and dist.is_contiguous()
                    and is_match.is_contiguous()):
        raise ValueError("commit_fsm: span and dist must be contiguous "
                         "int64 and is_match contiguous bool on CUDA")
    heads = torch.empty(span.shape, dtype=torch.bool, device=span.device)
    eff = torch.empty(span.shape, dtype=torch.int64, device=span.device)
    if span.numel():
        commit_fsm_into(span, is_match, dist, seg, heads, eff)
        _build.count_launch(commit_fsm)
    return heads, eff


def build_code_lens(hist: torch.Tensor, refine_passes: int = 0,
                    max_len: int = MAX_CODE_LEN):
    """Kraft-exact length assignment, lengths <= max_len, per row of hist
    [R, nsym] (``_build_code_lens``), then ``refine_passes`` budget-neutral
    passes.  Returns (lens [R, nsym], ok [R])."""
    R, nsym = hist.shape
    dev = hist.device
    hist = hist.to(torch.int64)
    total = torch.clamp(hist.sum(1), min=1)
    used = hist > 0
    kraft = 1 << max_len
    # the same two correctly rounded f32 operations as the JAX code:
    # f32(kraft) / f32(total), then hist * that
    scale = torch.full((R,), float(kraft), dtype=torch.float32,
                       device=dev) / total.to(torch.float32)
    share = (hist.to(torch.float32) * scale[:, None]).to(torch.int64)
    e = bsr(torch.clamp(share, min=1))
    half = 1 << torch.clamp(e - 1, min=0)
    # uint32 difference: share 0 wraps and always bumps, as in JAX
    bump = ((share - (1 << e)) & M32) > half
    e = e + bump.to(torch.int64)
    k_des = torch.where(used, 1 << torch.clamp(e, 0, max_len - 1), 0)

    ar = torch.arange(nsym, device=dev)
    order = torch.argsort(-(hist * 512 + (nsym - ar)), dim=1)  # unique keys
    k_sorted = k_des.gather(1, order)
    used_sorted = used.gather(1, order)
    us = used_sorted.to(torch.int64)
    remaining_after = torch.flip(torch.cumsum(torch.flip(us, [1]), 1),
                                 [1]) - us

    # frequency-descending greedy spend, reserving 1 unit per later symbol
    budget = torch.full((R,), kraft, dtype=torch.int64, device=dev)
    k_got = torch.empty_like(k_sorted)
    for j in range(nsym):
        allow = torch.clamp(budget - remaining_after[:, j], min=1)
        kj = torch.where(used_sorted[:, j],
                         1 << bsr(torch.minimum(k_sorted[:, j], allow)), 0)
        budget = budget - kj
        k_got[:, j] = kj
    k = torch.zeros_like(k_got).scatter_(1, order, k_got)

    # spend the remainder exactly: double the largest k <= r, else halve
    # the smallest k > r; first index on ties (unique keys below)
    r = kraft - k.sum(1)
    for _ in range(48):
        can_dbl = used & (k <= r[:, None]) & (k < (kraft >> 1))
        any_dbl = can_dbl.any(1)
        dbl_pick = torch.argmax(
            torch.where(can_dbl, k, -1) * 512 + (511 - ar), dim=1)
        can_hlv = used & (k > r[:, None]) & (k >= 2)
        hlv_pick = torch.argmin(
            torch.where(can_hlv, k, 1 << 30) * 512 + ar, dim=1)
        idx = torch.where(any_dbl, dbl_pick, hlv_pick)
        kidx = k.gather(1, idx[:, None])[:, 0]
        delta = torch.where(any_dbl, kidx, -(kidx >> 1))
        live = r > 0
        k = torch.where(live[:, None] & (ar == idx[:, None]),
                        k + delta[:, None], k)
        r = torch.where(live, r - delta, r)
    lens = torch.where(k > 0, max_len - bsr(torch.clamp(k, min=1)), 0)

    # budget-neutral refinement: at each level l = 2..max_len, shorten the
    # most frequent symbol of length l and lengthen the least frequent of
    # length l-1 when that saves bits; first index on ties (unique keys)
    for _ in range(refine_passes):
        for ln in range(2, max_len + 1):
            at_l = used & (lens == ln)
            at_lm1 = used & (lens == ln - 1)
            a = torch.argmax(torch.where(at_l, hist, -1) * 512 + (511 - ar),
                             dim=1, keepdim=True)
            b = torch.argmin(torch.where(at_lm1, hist, 1 << 30) * 512 + ar,
                             dim=1, keepdim=True)
            good = (at_l.any(1, keepdim=True) & at_lm1.any(1, keepdim=True)
                    & (hist.gather(1, a) > hist.gather(1, b)))
            lens = (lens - (good & (ar == a)).long()
                    + (good & (ar == b)).long())
    return lens, (r == 0) & (used.sum(1) >= 2)


def code_lens_into(hist: torch.Tensor, refine_passes: int, max_len: int,
                   lens: torch.Tensor, ok: torch.Tensor) -> None:
    """The bare launch of the code-length kernel on CUDA tensors: hist
    contiguous int64 [R, nsym], lens int64 [R, nsym] and ok bool [R],
    every element written.  Counts nothing: ``code_lens`` is the
    wrapper."""
    R, nsym = hist.shape
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("code_lens", "code_lens_launch",
                       [P, P, P, I, I, I, I, P])
    with _build.launch_context((hist, lens, ok), "code_lens") as stream:
        _check(fn(_ptr(hist), _ptr(lens), _ptr(ok), R, nsym, refine_passes,
                  max_len, stream), "code_lens")


def code_lens(hist: torch.Tensor, refine_passes: int, max_len: int):
    """Kraft-exact code lengths of every row of hist [R, nsym]
    (``_build_code_lens``, then ``refine_passes`` refinement passes) ->
    (lens int64 [R, nsym], ok bool [R]).  CUDA kernel for CUDA tensors
    (contiguous int64 counts below 2**30, nsym <= 512, max_len <= 15,
    read as they are: the wrapper allocates the outputs and launches,
    nothing else), the plain version (``build_code_lens``) for CPU
    tensors."""
    if hist.dim() != 2:
        raise ValueError("code_lens: hist must be [R, nsym]")
    if hist.device.type == "cpu":
        return build_code_lens(hist, refine_passes, max_len)
    R, nsym = hist.shape
    if hist.dtype != torch.int64 or not hist.is_contiguous() \
            or not 1 <= nsym <= CODE_LENS_MAX_SYM or refine_passes < 0 \
            or not 2 <= max_len <= CODE_LENS_MAX_LEN:
        raise ValueError(f"code_lens: hist must be contiguous int64 with 1 "
                         f"to {CODE_LENS_MAX_SYM} symbols, refine_passes "
                         f">= 0 and max_len 2 to {CODE_LENS_MAX_LEN} on "
                         f"CUDA")
    lens = torch.empty(R, nsym, dtype=torch.int64, device=hist.device)
    ok = torch.empty(R, dtype=torch.bool, device=hist.device)
    if R:
        code_lens_into(hist, refine_passes, max_len, lens, ok)
        _build.count_launch(code_lens)
    return lens, ok


reset_launch_counts()
