"""The sorted matchfind's probes after the sort: wrapper, launch count.

``segment_probe`` (C5, kernel ``segment_probe`` in
``csrc/segment_probe.cu``) replaces XLA code, not a Pallas kernel: the
work of ``_sorted_matchfind`` (``libdeflate_tpu/compress/
tpu_pipeline.py:192``) after its sort, in the two forms levels 0-7 run:

- ``"best"``, the best probe of each position (``_sorted_matchfind``
  without ``return_triple`` or ``wide_ext``), for the static tier, dyn1
  and the rescue pass; plain version ``pipeline.sorted_best``;
- ``"lean"``, the best, the best at another distance and the nearest
  candidate with C packed lean (``return_triple`` over 8- or 16-byte
  payloads), for the lean DP tiers and the mesh's levels 5-7; plain
  version ``pipeline.sorted_matchfind_lean``.

The 32-byte triple, the ``wide_ext`` best two and ``hash3_matchfind``
stay on the plain path.  The wrapper takes the hash ``h`` and the padded
bytes ``bp`` (int64 and uint8 [B, n]), sorts every ``seg``-position
segment by (hash, position) with ``torch.sort`` and hands the kernel the
sorted keys, from which it reads each slot's position and its payload
straight from the bytes: the payload words, their gathers and the
scatter back are not made.  ``shift`` reads the payloads that many bytes
on (the rescue pass's half segment).  For CUDA tensors it launches the
kernel or raises; CPU tensors take the plain version, on the payload
words made from the bytes (``payload_words``).  ``check_probe`` raises,
before any launch (and on the CPU alike), on a form, payload width or
depth the kernel does not take.  Launches are counted in
``segment_probe.launches`` and go through ``_build.launch_context``.  ``pipeline`` imports this module when called
(this module imports ``pipeline``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import pipeline
from .kernels import _check

FORMS = ("best", "lean")
WIDTHS = (8, 16)          # payload bytes: two or four words
MAX_DEPTH = 32            # the halo of sorted slots a block keeps
OUTPUTS = {"best": 3, "lean": 9}


def reset_launch_counts() -> None:
    segment_probe.launches = 0


def check_probe(form: str, width: int, depth: int) -> None:
    """Raise unless C5 takes ``form``, a payload of ``width`` bytes and
    ``depth`` probes."""
    if form not in FORMS:
        raise ValueError(f"segment_probe: form {form!r}; the kernel takes "
                         f"{FORMS}")
    if width not in WIDTHS:
        raise ValueError(f"segment_probe: payload width {width}; the kernel "
                         f"takes {WIDTHS} bytes")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"segment_probe: depth {depth}; the kernel takes "
                         f"1 to {MAX_DEPTH}")


def payload_words(bp: torch.Tensor, width: int, shift: int = 0):
    """The plain version's payload words: the little-endian words at
    every position ``shift`` bytes on, and those 4, 8 and 12 bytes
    further (``width`` / 4 of them), zero past the row's end."""
    if shift:
        bp = torch.cat([bp[:, shift:], torch.zeros_like(bp[:, :shift])], 1)
    words = pipeline.le32_words(bp)
    return (words,) + tuple(pipeline.ahead(words, k)
                            for k in range(4, width, 4))


def sort_keys(h: torch.Tensor, seg: int) -> torch.Tensor:
    """Every ``seg``-position segment's keys h << pos_bits | position,
    sorted ([rows, seg] int64): the plain version's sort."""
    rows = h.numel() // seg
    pos_bits = pipeline.seg_key_params(seg)[0]
    lp = torch.arange(seg, device=h.device, dtype=torch.int64)
    return torch.sort((h.reshape(rows, seg) << pos_bits) | lp, dim=1).values


def segment_probe_into(bp, keys, outs, form: str, width: int, seg: int,
                       depth: int, shift: int = 0) -> None:
    """The bare launch of C5 on CUDA tensors: ``bp`` uint8 [B, n],
    ``keys`` the sorted keys ([rows, seg], rows x seg = B x n), ``outs``
    3 (best) or 9 (lean) int64 arrays of B x n, every element written.
    Allocates the kernel's scratch: a packed word a position (32 bits for
    best, 64 for lean) and a zeroed count of finished tiles a segment.
    Counts nothing: ``segment_probe`` is the wrapper."""
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("segment_probe", "segment_probe_launch",
                       [P, P, P, P, P, I, I, I, I, I, I, I, I, I, P])
    pos_bits, junk = pipeline.seg_key_params(seg)
    lean = form == "lean"
    packed = torch.empty(keys.numel(), device=keys.device,
                         dtype=torch.int64 if lean else torch.int32)
    done = torch.zeros(keys.shape[0], device=keys.device, dtype=torch.int32)
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    with _build.launch_context([bp, keys, packed, done, *outs],
                               "segment_probe") as stream:
        _check(fn(bp.data_ptr(), keys.data_ptr(), ptrs, packed.data_ptr(),
                  done.data_ptr(), int(lean), width, keys.shape[0], seg,
                  bp.shape[1], shift, pos_bits, junk, depth, stream),
               "segment_probe")


def _check_arrays(h: torch.Tensor, bp: torch.Tensor, seg: int,
                  shift: int) -> None:
    B, n = h.shape
    if h.dtype != torch.int64 or bp.dtype != torch.uint8 \
            or bp.shape != h.shape or not h.is_contiguous() \
            or not bp.is_contiguous() or n % seg or n % 4 \
            or not 0 <= shift < max(n, 1):
        raise ValueError(f"segment_probe: h int64 and bp uint8, contiguous "
                         f"[B, n] of one shape with n a multiple of the "
                         f"segment ({seg}) and of 4 and 0 <= shift < n; got "
                         f"{h.dtype} {list(h.shape)}, {bp.dtype} "
                         f"{list(bp.shape)}, shift {shift}")


def segment_probe(h, bp, seg: int, depth: int, width: int,
                  form: str = "best", shift: int = 0):
    """The sorted matchfind of every ``seg``-position segment of the hash
    ``h`` (int64 [B, n]) over the payloads of ``width`` bytes read from
    ``bp`` (uint8 [B, n], ``shift`` bytes on): "best" -> (mlen, dist,
    fine), "lean" -> the (A, B, C) triples, each [B, n] and in position
    order, as ``pipeline.sorted_best`` and
    ``pipeline.sorted_matchfind_lean`` return them.  C5 for CUDA tensors,
    those plain versions for CPU tensors."""
    check_probe(form, width, depth)
    if h.device.type == "cpu":
        ws = payload_words(bp, width, shift)
        if form == "best":
            return pipeline.sorted_best(h, ws, seg, depth)
        return pipeline.sorted_matchfind_lean(h, ws, seg, depth)
    _check_arrays(h, bp, seg, shift)
    bp = bp if bp.data_ptr() % 4 == 0 else bp.clone()
    outs = [torch.empty_like(h) for _ in range(OUTPUTS[form])]
    if h.numel():
        segment_probe_into(bp, sort_keys(h, seg), outs, form, width, seg,
                           depth, shift)
        _build.count_launch(segment_probe)
    if form == "best":
        return tuple(outs)
    return tuple(tuple(outs[i:i + 3]) for i in (0, 3, 6))


reset_launch_counts()
