"""The compress paths' two loop kernels: wrappers, launch counts.

They replace XLA loop code (``lax.scan``s), not Pallas kernels:

- ``commit_fsm`` replaces ``_greedy_commit_merge``
  (``libdeflate_tpu/compress/tpu_pipeline.py:771-826``, its scan at
  ``:809``), the commit FSM with same-distance merging; kernel
  ``csrc/commit_fsm.cu``, plain version ``pipeline.greedy_commit_merge``.
- ``code_lens`` replaces ``_build_code_lens``
  (``libdeflate_tpu/compress/tpu_dynamic.py:140-262``: the spend, fix and
  refinement scans), one histogram row a block; kernel
  ``csrc/code_lens.cu``, plain version ``dynamic.build_code_lens``.

A wrapper given CUDA tensors launches its kernel or raises; it takes the
plain version only for tensors on the CPU.  Each wrapper counts its
kernel launches in its ``launches`` attribute and launches through
``_build.launch_context``, as ``kernels.py``'s do.  ``pipeline.commit_items``
and ``dynamic.build_code_lens_pair`` call them through this module, which
they import when called (this module imports both).
"""

from __future__ import annotations

import torch

from .. import _build
from .dynamic import build_code_lens
from .kernels import _check, _ptr
from .pipeline import greedy_commit_merge

CODE_LENS_MAX_SYM = 512     # the rank order's keys hist * 512 + nsym - i
CODE_LENS_MAX_LEN = 15


def reset_launch_counts() -> None:
    commit_fsm.launches = 0
    code_lens.launches = 0


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
    else), the plain version (``pipeline.greedy_commit_merge``) for CPU
    tensors."""
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
    nothing else), the plain version (``dynamic.build_code_lens``) for CPU
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
