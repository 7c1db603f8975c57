"""The candidate stage's chain extension: wrappers, plain versions,
launch counts.

They replace XLA code, not Pallas kernels, both in
``csrc/chain_extend.cu``:

- ``chain_extend_multi`` (C3, kernel ``chain_relax``) replaces
  ``_chain_extend_multi`` (``libdeflate_tpu/compress/tpu_pipeline.py:
  690-736``), the multi-stride relaxation of 2, 3 or 5 candidates on
  every DP tier; plain version ``chain_extend_multi_plain``.
- ``chain_extend`` and ``chain_extend2`` (C4, kernel ``chain_double``)
  replace ``_chain_extend`` (``:631-651``) and ``_chain_extend2``
  (``:654-687``), the stride-8 doubling of the greedy tiers' sorted
  matchfind and of the rescue pass; plain versions
  ``chain_extend_plain`` and ``chain_extend2_plain``.

Each takes its plain version's arguments and returns what it returns.  A
wrapper given CUDA tensors launches its kernel or raises; it takes the
plain version only for tensors on the CPU.  On CUDA every array is a
contiguous int64 [..., n] of one shape (a row is the last axis, as
``bits.ahead`` shifts it), with values within +-2**30 (the JAX
package's int32); ``chain_extend_multi`` takes K = 2, 3 or 5 candidates
(the only K the JAX package calls it with) and up to 16 strides of at
least 1 summing to at most 1024 whose carry and two tile buffers fit a
block's 227 KiB of shared memory (``smem_bytes``, ``MAX_SMEM``; at K = 5
and the default tile, one stride of at most 684).  Each wrapper counts
its launches in its ``launches`` attribute and launches through
``_build.launch_context``.  ``tile`` sets the positions of a tile (1 to
1024), the unit a block of the kernels' persistent grid walks down a
row, for the checks that cross tiles on small rows.  Any number of rows
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .bits import MAX_LEN, STRIDES, ahead
from .kernels import _check

RELAX_KS = (2, 3, 5)
MAX_STRIDES = 16
MAX_HALO = 1024         # the strides' sum: the carry a block keeps
MAX_SMEM = 227 * 1024 - 4 * MAX_STRIDES   # dynamic: less the strides' copy
TILE = 1024             # positions a tile
DOUBLE_STRIDES = (8, 16, 32, 64, 128, 256)   # C4's, as the plain loop's


def reset_launch_counts() -> None:
    chain_extend_multi.launches = 0
    chain_extend.launches = 0
    chain_extend2.launches = 0


def smem_bytes(K: int, strides, tile: int = TILE) -> int:
    """A block's shared memory at K candidates: two tile buffers of r, d
    and f, each max(tile + the largest stride, the strides' sum)
    positions wide, and the carry of the strides' sum (r and f), int32."""
    halo = sum(strides)
    width = max(tile + max(strides, default=0), halo)
    return 4 * (6 * K * width + 2 * K * halo)


def check_relax(K: int, strides, tile: int = TILE) -> None:
    """Raise unless C3 takes K candidates and ``strides`` (strides1 then
    strides2) at ``tile``."""
    if K not in RELAX_KS:
        raise ValueError(f"chain_extend_multi: {K} candidates; the kernel "
                         f"takes {RELAX_KS}")
    if len(strides) > MAX_STRIDES or any(s < 1 for s in strides) \
            or sum(strides) > MAX_HALO:
        raise ValueError(f"chain_extend_multi: strides {tuple(strides)}; "
                         f"the kernel takes up to {MAX_STRIDES} of at "
                         f"least 1 summing to at most {MAX_HALO}")
    if smem_bytes(K, strides, tile) > MAX_SMEM:
        raise ValueError(f"chain_extend_multi: strides {tuple(strides)} at "
                         f"{K} candidates and tile {tile} need "
                         f"{smem_bytes(K, strides, tile)} bytes of shared "
                         f"memory a block; the kernel takes at most "
                         f"{MAX_SMEM}")


def _check_arrays(what: str, arrays) -> None:
    shape = arrays[0].shape
    if any(a.shape != shape or a.dtype != torch.int64
           or not a.is_contiguous() for a in arrays) or not shape:
        raise ValueError(f"{what}: every array must be contiguous int64 of "
                         f"one shape [..., n] on CUDA")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def chain_extend_plain(mlen, dist, fine):
    """Stride-8 doubling (``_chain_extend``): where a match is exactly s
    bytes (word-granular) and the position s ahead has the same distance,
    splice its length and remainder in; s = 8, 16, 32, 64, 128, 256.
    Returns (len, dist), lengths capped at MAX_LEN."""
    r, f = mlen, fine
    s = 8
    while s < MAX_LEN:
        take = (r == s) & (ahead(dist, s) == dist)
        r = r + torch.where(take, ahead(r, s), 0)
        f = torch.where(take, ahead(f, s), f)
        s *= 2
    return torch.clamp(r + torch.where(r >= 4, f, 0), max=MAX_LEN), dist


def chain_extend2_plain(mA, dA, fA, mB, dB, fB):
    """Two-candidate stride-8 doubling (``_chain_extend2``): each chain
    splices the downstream A at its distance, else the downstream B; the
    longer extended match wins, ties to A.  Returns (len, dist)."""
    rA, fa, rB, fb = mA, fA, mB, fB
    s = 8
    while s < MAX_LEN:
        rA_s, dA_s, fa_s = ahead(rA, s), ahead(dA, s), ahead(fa, s)
        rB_s, dB_s, fb_s = ahead(rB, s), ahead(dB, s), ahead(fb, s)
        tA1 = (rA == s) & (dA_s == dA)
        tA2 = (rA == s) & ~tA1 & (dB_s == dA)
        tB1 = (rB == s) & (dA_s == dB)
        tB2 = (rB == s) & ~tB1 & (dB_s == dB)
        rA, fa, rB, fb = (
            rA + torch.where(tA1, rA_s, torch.where(tA2, rB_s, 0)),
            torch.where(tA1, fa_s, torch.where(tA2, fb_s, fa)),
            rB + torch.where(tB1, rA_s, torch.where(tB2, rB_s, 0)),
            torch.where(tB1, fa_s, torch.where(tB2, fb_s, fb)))
        s *= 2
    lenA = torch.clamp(rA + torch.where(rA >= 4, fa, 0), max=MAX_LEN)
    lenB = torch.clamp(rB + torch.where(rB >= 4, fb, 0), max=MAX_LEN)
    useB = lenB > lenA
    return torch.where(useB, lenB, lenA), torch.where(useB, dB, dA)


def chain_extend_multi_plain(cands, strides2=STRIDES, strides1=STRIDES):
    """N-candidate chain extension by multi-stride max-relaxation
    (``_chain_extend_multi``): a round of strides ``strides1``, then one
    of ``strides2`` (empty for the lean tiers); lcp(i, d) >= s implies
    lcp(i, d) = s + lcp(i+s, d).  Returns [(len, dist)] per candidate."""
    rs = [c[0] for c in cands]
    ds = [c[1] for c in cands]
    fs = [c[2] for c in cands]
    for s in tuple(strides1) + tuple(strides2):
        r_s = [ahead(r, s) for r in rs]
        d_s = [ahead(d, s) for d in ds]
        f_s = [ahead(f, s) for f in fs]
        new_r, new_f = [], []
        for k in range(len(cands)):
            can = rs[k] >= s
            r_new, f_new = rs[k], fs[k]
            for j in range(len(cands)):
                cand = torch.where(can & (d_s[j] == ds[k]), s + r_s[j], 0)
                better = cand > r_new
                f_new = torch.where(better, f_s[j], f_new)
                r_new = torch.where(better, cand, r_new)
            new_r.append(r_new)
            new_f.append(f_new)
        rs, fs = new_r, new_f
    return [(torch.clamp(r + torch.where(r >= 4, f, 0), max=MAX_LEN), d)
            for r, d, f in zip(rs, ds, fs)]


def chain_relax_into(cands, strides, outs, tile: int = TILE) -> None:
    """The bare launch of C3 on CUDA tensors: ``cands`` K (mlen, dist,
    fine) triples, ``strides`` the whole list (strides1 then strides2),
    ``outs`` K int64 arrays of the candidates' shape, every element
    written.  Counts nothing: ``chain_extend_multi`` is the wrapper."""
    flat = [x for c in cands for x in c]
    n = flat[0].shape[-1]
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("chain_extend", "chain_relax_launch",
                       [P, P, I, I, I, P, I, I, P])
    st = (ctypes.c_int * max(len(strides), 1))(*strides)
    with _build.launch_context(flat + list(outs), "chain_relax") as stream:
        _check(fn(_pointers(flat), _pointers(outs), len(cands),
                  flat[0].numel() // n if n else 0, n, st, len(strides),
                  tile, stream), "chain_relax")


def chain_double_into(cands, outs, tile: int = TILE) -> None:
    """The bare launch of C4 on CUDA tensors: ``cands`` one or two (mlen,
    dist, fine) triples, ``outs`` [len] or [len, dist], int64 arrays of
    their shape, every element written.  Counts nothing."""
    flat = [x for c in cands for x in c]
    n = flat[0].shape[-1]
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("chain_extend", "chain_double_launch",
                       [P, P, I, I, I, I, P])
    with _build.launch_context(flat + list(outs), "chain_double") as stream:
        _check(fn(_pointers(flat), _pointers(outs), len(cands),
                  flat[0].numel() // n if n else 0, n, tile, stream),
               "chain_double")


def chain_extend_multi(cands, strides2=STRIDES, strides1=STRIDES,
                       tile: int = TILE):
    """N-candidate chain extension by multi-stride max-relaxation
    (``_chain_extend_multi``), [(len, dist)] per candidate: C3 for CUDA
    tensors, ``chain_extend_multi_plain`` for CPU tensors."""
    cands = [tuple(c) for c in cands]
    if cands and cands[0][0].device.type == "cpu":
        return chain_extend_multi_plain(cands, strides2, strides1)
    strides = tuple(strides1) + tuple(strides2)
    check_relax(len(cands), strides, tile)
    _check_arrays("chain_extend_multi", [x for c in cands for x in c])
    outs = [torch.empty_like(c[0]) for c in cands]
    if outs[0].numel():
        chain_relax_into(cands, strides, outs, tile)
        _build.count_launch(chain_extend_multi)
    return [(ln, c[1]) for ln, c in zip(outs, cands)]


def chain_extend(mlen, dist, fine, tile: int = TILE):
    """Stride-8 doubling (``_chain_extend``) -> (len, dist): C4 for CUDA
    tensors, ``chain_extend_plain`` for CPU tensors."""
    if mlen.device.type == "cpu":
        return chain_extend_plain(mlen, dist, fine)
    _check_arrays("chain_extend", (mlen, dist, fine))
    out = torch.empty_like(mlen)
    if out.numel():
        chain_double_into([(mlen, dist, fine)], [out], tile)
        _build.count_launch(chain_extend)
    return out, dist


def chain_extend2(mA, dA, fA, mB, dB, fB, tile: int = TILE):
    """Two-candidate stride-8 doubling (``_chain_extend2``) -> (len,
    dist): C4 for CUDA tensors, ``chain_extend2_plain`` for CPU
    tensors."""
    if mA.device.type == "cpu":
        return chain_extend2_plain(mA, dA, fA, mB, dB, fB)
    _check_arrays("chain_extend2", (mA, dA, fA, mB, dB, fB))
    ln = torch.empty_like(mA)
    dist = torch.empty_like(dA)
    if ln.numel():
        chain_double_into([(mA, dA, fA), (mB, dB, fB)], [ln, dist], tile)
        _build.count_launch(chain_extend2)
    return ln, dist


reset_launch_counts()
