"""The sorted matchfind's probes after the sort: wrapper, plain
versions and the probe primitives they share, launch count.

``segment_probe`` (C5, kernel ``segment_probe`` in
``csrc/segment_probe.cu``) replaces XLA code, not a Pallas kernel: the
work of ``_sorted_matchfind`` (``libdeflate_tpu/compress/
tpu_pipeline.py:192``) after its sort, in the two forms levels 0-7 run:

- ``"best"``, the best probe of each position (``_sorted_matchfind``
  without ``return_triple`` or ``wide_ext``), for the static tier, dyn1
  and the rescue pass; plain version ``sorted_best``;
- ``"lean"``, the best, the best at another distance and the nearest
  candidate with C packed lean (``return_triple`` over 8- or 16-byte
  payloads), for the lean DP tiers and the mesh's levels 5-7; plain
  version ``sorted_matchfind_lean``.

The 32-byte triple, the ``wide_ext`` best two and ``hash3_matchfind``
stay plain PyTorch in ``pipeline``, on the primitives here
(``sorted_segments``, ``word_lcp``, the packings and ``unpermute``).
The wrapper takes the hash ``h`` and the padded
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
``segment_probe.launches`` and go through ``_build.launch_context``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .bits import DEPTH, WINDOW, ahead, le32_words, seg_key_params
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


def tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """The index of each 32-bit word's lowest nonzero byte (3 when the
    low three bytes are zero)."""
    return torch.where(
        (x & 0xFF) != 0, 0,
        torch.where((x & 0xFFFF) != 0, 1,
                    torch.where((x & 0xFFFFFF) != 0, 2, 3)))


def word_lcp(ok, xs):
    """Word-granular LCP of probes whose payload XORs are ``xs`` (w, w4,
    then w8, w12 and any wider words), gated by ``ok``: (mlen, fine,
    eq4), fine the byte remainder from the first unequal word (0 at full
    LCP), as ``_sorted_matchfind``'s and ``_pool_probe``'s probes
    compute it."""
    eq4 = eq = ok & (xs[0] == 0)
    mlen = 4 * eq4.long()
    chain = []
    for x in xs[1:]:
        eq = eq & (x == 0)
        mlen = mlen + 4 * eq.long()
        chain.append(eq)
    if len(xs) == 2:
        x_sel = torch.where(~chain[0], xs[1], 0)
    else:
        x_sel = xs[-1]
        for k in range(len(xs) - 3, -1, -1):
            x_sel = torch.where(~chain[k], xs[k + 1], x_sel)
    fine = torch.where((x_sel != 0) & eq4, tz_bytes(x_sel), 0)
    return mlen, fine, eq4


def sorted_segments(h, ws, seg: int):
    """Sort every ``seg``-position segment of [B, n] by (hash, position)
    with the payload words ``ws``: (w, w4), (w, w4, w8, w12) or those
    and the wide words w16..w28.  Returns the sort's order (each sorted
    slot's local position, [rows, seg]) and probe(d): per sorted slot,
    the word-granular (mlen, dist, fine) of the slot d before it in the
    same bucket, as ``_sorted_matchfind``'s probe computes it (lcp 8
    with two payloads, 16 with four, 32 with eight)."""
    rows = h.numel() // seg
    pos_bits, junk = seg_key_params(seg)
    lp = torch.arange(seg, device=h.device, dtype=torch.int64)
    # keys h<<pos_bits|lp are unique per row and may fill all 32 bits, so
    # they sort as int64; the sort's indices are the un-permutation
    sk, order = torch.sort((h.reshape(rows, seg) << pos_bits) | lp, dim=1)
    sws = [x.reshape(rows, seg).gather(1, order) for x in ws]
    shash = sk >> pos_bits
    col = lp[None, :]

    def probe(d):
        same = ((shash == torch.roll(shash, d, 1)) & (shash != junk)
                & (col >= d))
        dist = torch.where(same, order - torch.roll(order, d, 1), WINDOW + 1)
        mlen, fine, eq4 = word_lcp(same & (dist <= WINDOW),
                                   [x ^ torch.roll(x, d, 1) for x in sws])
        return mlen, torch.where(eq4, dist, 0), fine

    return order, probe


_INVD = WINDOW + 1


def pack_inv(mlen, dist, fine):
    """mlen<<18 | fine<<16 | (W+1 - dist): one maximum picks the longest,
    then the longest remainder, then the nearest candidate."""
    return (mlen << 18) | (fine << 16) | (_INVD - dist)


def unpack_inv(p):
    return p >> 18, (_INVD - (p & 0xFFFF)) & 0xFFFF, (p >> 16) & 3


def best_two(pays):
    """The best packed probe and the best at another distance (zero when
    there is none), each unpacked to (mlen, dist, fine)."""
    payA = functools.reduce(torch.maximum, pays)
    invA = payA & 0xFFFF
    payB = torch.zeros_like(payA)
    for p in pays:
        payB = torch.maximum(payB, torch.where((p & 0xFFFF) != invA, p, 0))
    nz2 = payB != 0
    return (unpack_inv(payA),
            tuple(torch.where(nz2, x, 0) for x in unpack_inv(payB)))


def unpermute(order, shape, *pays):
    """Sorted-order payloads back to position order, reshaped to
    ``shape``."""
    return [torch.empty_like(p).scatter_(1, order, p).reshape(shape)
            for p in pays]


def pay(mlen, dist, fine):
    return (mlen << 18) | (fine << 16) | dist


def unpay(x):
    return x >> 18, x & 0xFFFF, (x >> 16) & 3


def sorted_best(h, ws, seg: int, depth: int = 2):
    """The best probe per position of ``_sorted_matchfind`` without
    ``return_pair``/``return_triple``/``wide_ext``, before its chain
    extension: one sort of every ``seg``-position segment, ``depth``
    probes each over the payload words ``ws`` ((w, w4) or (w, w4, w8,
    w12)), the longest, then the longest remainder, then the nearest.
    Returns (mlen, dist, fine) [B, n], word-granular.  The plain version
    of ``segment_probe``'s "best" form."""
    order, probe = sorted_segments(h, ws, seg)
    pays = [pack_inv(*probe(d)) for d in range(1, depth + 1)]
    best, = unpermute(order, h.shape, functools.reduce(torch.maximum, pays))
    return unpack_inv(best)


def sorted_matchfind_lean(h, ws, seg: int, depth: int = DEPTH):
    """Lean branch of ``_sorted_matchfind`` (``return_triple=True``,
    ``wide=None``) over the payload words ``ws``, (w, w4, w8, w12) or (w,
    w4): the best, the best at another distance, and the nearest
    same-hash candidate per position, each as word-granular (mlen, dist,
    fine) [B, n] triples.  Candidate C keeps the JAX path's packing loss:
    its length is capped to 12 in steps of 4 and its ``fine`` is 0.  The
    plain version of ``segment_probe``'s "lean" form."""
    order, probe = sorted_segments(h, ws, seg)
    mlenC, distC, fineC = probe(1)
    pays = [pack_inv(mlenC, distC, fineC)]
    pays += [pack_inv(*probe(d)) for d in range(2, depth + 1)]
    a, b = best_two(pays)
    # C rides payload bits 23..31 of both words as (len/4 capped at 3, dist)
    cbits = (torch.clamp(mlenC >> 2, 0, 3) << 16) | distC
    pa, pb = unpermute(order, h.shape,
                       pay(*a) | ((cbits & 0x1FF) << 23),
                       pay(*b) | ((cbits >> 9) << 23))
    cb = ((pa >> 23) & 0x1FF) | (((pb >> 23) & 0x1FF) << 9)

    def unpack(x):
        return (x >> 18) & 0x1F, x & 0xFFFF, (x >> 16) & 3

    triC = ((cb >> 16) << 2, cb & 0xFFFF, torch.zeros_like(cb))
    return unpack(pa), unpack(pb), triC


def payload_words(bp: torch.Tensor, width: int, shift: int = 0):
    """The plain version's payload words: the little-endian words at
    every position ``shift`` bytes on, and those 4, 8 and 12 bytes
    further (``width`` / 4 of them), zero past the row's end."""
    if shift:
        bp = torch.cat([bp[:, shift:], torch.zeros_like(bp[:, :shift])], 1)
    words = le32_words(bp)
    return (words,) + tuple(ahead(words, k)
                            for k in range(4, width, 4))


def sort_keys(h: torch.Tensor, seg: int) -> torch.Tensor:
    """Every ``seg``-position segment's keys h << pos_bits | position,
    sorted ([rows, seg] int64): the plain version's sort."""
    rows = h.numel() // seg
    pos_bits = seg_key_params(seg)[0]
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
    pos_bits, junk = seg_key_params(seg)
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
    order, as ``sorted_best`` and ``sorted_matchfind_lean`` return them.
    C5 for CUDA tensors, those plain versions for CPU tensors."""
    check_probe(form, width, depth)
    if h.device.type == "cpu":
        ws = payload_words(bp, width, shift)
        if form == "best":
            return sorted_best(h, ws, seg, depth)
        return sorted_matchfind_lean(h, ws, seg, depth)
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
