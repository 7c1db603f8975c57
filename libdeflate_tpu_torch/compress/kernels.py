"""The compress paths' two kernels: wrappers, plain versions, launch
counts.

Counterpart of ``libdeflate_tpu/compress/pallas_kernels.py``:

- ``dp_parse`` replaces ``dp_parse_pallas`` (lines 198-270, body
  ``_dp_kernel`` 94-195), the backwards min-cost DP; kernel
  ``csrc/dp_parse.cu``, plain version ``dp_parse_plain``.
- ``pack_groups`` replaces ``pack_groups_pallas`` (312-347, body
  ``_pack_kernel`` 276-309), the bit placement; kernel
  ``csrc/pack_groups.cu``, plain version ``group_place``.

A wrapper given CUDA tensors launches its kernel or raises; it takes the
plain version only for tensors on the CPU.  Each wrapper counts its
kernel launches in its ``launches`` attribute (``_build.count_launch``)
and launches on its tensors' device and that device's current stream
(``_build.launch_context``), so that shards on other devices or streams
launch where their tensors are.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .bits import M32, MAX_LEN

# slot-top lengths: 3..10, then the top of each extra-bit band, then 258
# (tpu_optimal.LEN_LADDER)
LEN_LADDER = (3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 22, 26, 30, 34, 42,
              50, 58, 66, 82, 98, 114, 130, 162, 194, 226, 258)
# every length 3..34, then the band tops above (tpu_optimal.LEN_LADDER_DENSE)
LEN_LADDER_DENSE = tuple(range(3, 35)) + (38, 42, 46, 50, 58, 66, 82, 98,
                                          114, 130, 162, 194, 226, 258)
# every length 3..66, then half-band steps (tpu_optimal.LEN_LADDER_DENSE2)
LEN_LADDER_DENSE2 = tuple(range(3, 67)) + (74, 82, 90, 98, 106, 114, 122,
                                           130, 146, 162, 178, 194, 210,
                                           226, 242, 258)
# the ladders csrc/dp_parse.cu instantiates (each rung table computed
# arithmetically there), told apart by their rung counts
LADDERS = {len(lad): lad for lad in (LEN_LADDER, LEN_LADDER_DENSE,
                                     LEN_LADDER_DENSE2)}
WIN = 512                  # circular cost-window rows (>= 259, power of 2)
PACK_MAX_CAPW1 = 82        # pack_groups_pallas's widest row (128 - 46)
_BIG = 1 << 28
_BIG2 = 1 << 29
_LC_ENTRIES = 259


def reset_launch_counts() -> None:
    dp_parse.launches = 0
    pack_groups.launches = 0


def _i32(x: torch.Tensor) -> torch.Tensor:
    """x as int32 values (wrapped mod 2**32, as ``astype(int32)``), held
    in int64."""
    return ((x.to(torch.int64) + (1 << 31)) & M32) - (1 << 31)


def _caps(cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3, cd3,
          lc_len, B):
    """The kernel's fields, as ``dp_parse_pallas`` packs them into five
    int32 words (``pallas_kernels.py:225-239``) and ``_dp_kernel`` reads
    them back (``:128-139``): literal cost capped at 0xFF, offset costs
    at 0x3FF, lc at 2**20, and nothing masked before packing, so a field
    that overflows its bits spills into its neighbour (a distance of
    2**18 or more into its length, a d3 of 2**14 or more into the literal
    cost and the C offset cost).  Lengths come back as the words' signed
    top 14 bits."""
    c = torch.clamp
    lc = c(_i32(lc_len), max=1 << 20)
    if lc.dim() == 1:
        lc = lc.expand(B, _LC_ENTRIES)
    cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3, cd3 = map(
        _i32, (cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3,
               cd3))
    wl = _i32((c(cdC, max=0x3FF) << 22) | (c(cost_lit, max=0xFF) << 14)
              | d3)
    wa, wb, wd = (_i32((ln << 18) | d) for ln, d in
                  ((lenA, dA), (lenB, dB), (lenC, dC)))
    wc = _i32((c(cdA, max=0x3FF) << 20) | (c(cdB, max=0x3FF) << 10)
              | c(cd3, max=0x3FF))
    return dict(
        clit=(wl >> 14) & 0xFF, d3=wl & 0x3FFF,
        cC=((wl & M32) >> 22) & 0x3FF,
        lA=wa >> 18, dA=wa & 0x3FFFF, lB=wb >> 18, dB=wb & 0x3FFFF,
        lC=wd >> 18, dC=wd & 0x3FFFF,
        cA=(wc >> 20) & 0x3FF, cB=(wc >> 10) & 0x3FF, c3=wc & 0x3FF, lc=lc)


def _split_choice(choice: torch.Tensor):
    return (choice >> 16) & 0xFFFF, choice & 0xFFFF


def ladder_rungs(ladder) -> int:
    """The rung count that names ``ladder`` to the kernel; a ladder other
    than LEN_LADDER, LEN_LADDER_DENSE and LEN_LADDER_DENSE2 raises."""
    ladder = tuple(int(f) for f in ladder)
    if LADDERS.get(len(ladder)) != ladder:
        raise ValueError("dp_parse: the ladder must be LEN_LADDER, "
                         "LEN_LADDER_DENSE or LEN_LADDER_DENSE2")
    return len(ladder)


def dp_parse_plain(cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC,
                   d3, cd3, lc_len, S: int, ladder=LEN_LADDER_DENSE2):
    """Plain PyTorch version of the DP kernel on [B, n_pad] inputs.

    Backwards over t = S-1..0 for every S-position segment (lane) at
    once: the literal edge, the ladder's rungs (the cheapest of A/B/C
    with len >= f, plus d3 at f = 3) and the tail edge of length S-t.
    The first minimum over [literal, rungs in ladder order, tail] is the
    kernel's "only a strictly lower cost replaces" rule.  lc_len is one
    [259] table or one per chunk [B, 259], read per lane's own chunk.
    Returns (span, dist) int64 [B, n_pad]."""
    B, n_pad = cost_lit.shape
    lpc = n_pad // S
    lanes = B * lpc
    dev = cost_lit.device
    x = _caps(cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3,
              cd3, lc_len, B)
    lc = x.pop("lc").repeat_interleave(lpc, 0)               # [lanes, 259]
    r = {k: v.reshape(lanes, S).T for k, v in x.items()}     # [S, lanes]

    nr = ladder_rungs(ladder)
    ladder = torch.tensor(LADDERS[nr], device=dev)
    f = ladder[:, None]
    lc_rungs = lc[:, ladder].T                               # [nr, lanes]
    order = torch.arange(nr + 2, device=dev)[:, None]
    D = torch.zeros(WIN, lanes, dtype=torch.int64, device=dev)
    choice = torch.empty(S, lanes, dtype=torch.int64, device=dev)

    def pick(t, flen):
        """Cheapest of A/B/C with len >= flen: (offset cost, dist)."""
        cd = torch.where(r["lA"][t] >= flen, r["cA"][t], _BIG)
        dsel = r["dA"][t].expand_as(cd)
        for k in "BC":
            use = (r["l" + k][t] >= flen) & (r["c" + k][t] < cd)
            cd = torch.where(use, r["c" + k][t], cd)
            dsel = torch.where(use, r["d" + k][t], dsel)
        return cd, dsel

    for t in range(S - 1, -1, -1):
        cd, dsel = pick(t, f)                                # [nr, lanes]
        use3 = (r["d3"][t] > 0) & (r["c3"][t] < cd[0])
        cd[0] = torch.where(use3, r["c3"][t], cd[0])
        dsel[0] = torch.where(use3, r["d3"][t], dsel[0])
        cand = torch.where(t + f <= S, cd + lc_rungs + D[(t + ladder) % WIN],
                           _BIG2)
        f_tail = S - t
        if 3 <= f_tail <= MAX_LEN:
            cd_t, dsel_t = pick(t, f_tail)
            c_tail = cd_t + lc[:, f_tail]
        else:
            c_tail = torch.full_like(cand[0], _BIG2)
            dsel_t = torch.zeros_like(c_tail)
        lit = r["clit"][t] + D[(t + 1) % WIN]
        costs = torch.cat([lit[None], cand, c_tail[None]])
        j = torch.argmin(costs * 128 + order, 0)             # unique keys
        spans = torch.cat([torch.ones_like(lit[None]),
                           f.expand_as(cand),
                           torch.full_like(lit[None], f_tail)])
        dists = torch.cat([torch.zeros_like(lit[None]), dsel, dsel_t[None]])
        D[t % WIN] = costs.gather(0, j[None])[0]
        choice[t] = ((spans.gather(0, j[None])[0] << 16)
                     | dists.gather(0, j[None])[0])
    return _split_choice(choice.T.reshape(B, n_pad))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error "
                           f"{err}")


def dp_parse_into(arrs, lc_len, S: int, span: torch.Tensor,
                  dist: torch.Tensor, ladder=LEN_LADDER_DENSE2) -> None:
    """The bare launch of the DP kernel on CUDA tensors: the twelve
    [B, n_pad] contiguous int64 arrays ``arrs``, lc_len contiguous int32
    or int64 [259] or [B, 259] (non-negative), span and dist int64
    [B, n_pad], every element written, ``ladder`` one of ``LADDERS``.
    Counts nothing: ``dp_parse`` is the wrapper."""
    B, n_pad = arrs[0].shape
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("dp_parse", "dp_parse_launch",
                       [P] * 13 + [I, I, P, P, I, I, I, I, P])
    with _build.launch_context(tuple(arrs) + (lc_len, span, dist),
                               "dp_parse") as stream:
        _check(fn(*map(_ptr, arrs), _ptr(lc_len),
                  int(lc_len.dtype == torch.int64),
                  1 if lc_len.dim() == 1 else B, _ptr(span), _ptr(dist), S,
                  B * (n_pad // S), n_pad // S, ladder_rungs(ladder),
                  stream), "dp_parse")


def dp_parse(cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3, cd3,
             lc_len, S: int, ladder=LEN_LADDER_DENSE2):
    """Backwards min-cost DP (``dp_parse_pallas``): [B, n_pad] candidate
    and cost arrays plus the [259] or [B, 259] per-length match costs ->
    (span, dist) int64 [B, n_pad], over ``ladder`` (one of ``LADDERS``;
    another ladder raises).  CUDA kernel for CUDA tensors
    (contiguous int64 arrays, an int32 or int64 lc_len of non-negative
    costs, read as they are: the wrapper allocates the outputs and
    launches, nothing else), the plain version for CPU tensors."""
    arrs = (cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC, d3, cd3)
    B, n_pad = cost_lit.shape
    if any(a.shape != (B, n_pad) for a in arrs) or n_pad % S:
        raise ValueError("dp_parse: inputs must share one [B, n_pad] shape "
                         "with n_pad a multiple of S")
    ladder_rungs(ladder)
    if cost_lit.device.type == "cpu":
        return dp_parse_plain(*arrs, lc_len, S, ladder)
    if any(a.dtype != torch.int64 or not a.is_contiguous() for a in arrs):
        raise ValueError("dp_parse: the [B, n_pad] arrays must be contiguous "
                         "int64 on CUDA")
    if lc_len.dtype not in (torch.int32, torch.int64) \
            or not lc_len.is_contiguous() \
            or lc_len.shape not in ((_LC_ENTRIES,), (B, _LC_ENTRIES)):
        raise ValueError("dp_parse: lc_len must be a contiguous int32 or "
                         "int64 [259] or [B, 259] table on CUDA")
    span = torch.empty(B, n_pad, dtype=torch.int64, device=cost_lit.device)
    dist = torch.empty_like(span)
    if span.numel():
        dp_parse_into(arrs, lc_len, S, span, dist, ladder)
        _build.count_launch(dp_parse)
    return span, dist


def group_place(sbuf: torch.Tensor, gw: torch.Tensor,
                nwords: int) -> torch.Tensor:
    """Add whole group buffers at their start words (``_group_place``);
    the plain version of the pack kernel.  sbuf int64 [B, m, capw+1],
    gw [B, m] -> int64 words [B, nwords].  Targets past the end carry
    only zero bits and are clamped onto the last word, as in JAX."""
    B, m, capw1 = sbuf.shape
    tgt = gw[..., None] + torch.arange(capw1, device=sbuf.device)
    tgt = torch.clamp(tgt, max=nwords - 1)
    tgt = tgt + nwords * torch.arange(B, device=sbuf.device)[:, None, None]
    words = torch.zeros(B * nwords, dtype=torch.int64, device=sbuf.device)
    words.index_add_(0, tgt.reshape(-1), sbuf.reshape(-1))
    return words.reshape(B, nwords) & M32


def pack_groups_into(sbuf: torch.Tensor, gw: torch.Tensor,
                     out: torch.Tensor) -> None:
    """The bare launch of the pack kernel on CUDA tensors: sbuf int64
    [B, m, capw+1], gw int64 [B, m], out int64 [B, nwords], all
    contiguous; every word of out is written.  Counts nothing:
    ``pack_groups`` is the wrapper."""
    B, m, capw1 = sbuf.shape
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("pack_groups", "pack_groups_launch",
                       [P, P, P, I, I, I, I, P])
    with _build.launch_context((sbuf, gw, out), "pack_groups") as stream:
        _check(fn(_ptr(sbuf), _ptr(gw), _ptr(out), B, m, capw1,
                  out.shape[1], stream), "pack_groups")


def pack_groups(sbuf: torch.Tensor, gw: torch.Tensor,
                nwords: int) -> torch.Tensor:
    """Place group buffers at their start words (``pack_groups_pallas``):
    sbuf [B, m, capw+1] 32-bit words (int64), gw [B, m] start words,
    non-decreasing within each chunk -> int64 words [B, nwords].  The
    groups' bits are disjoint, so OR and add agree.  CUDA kernel for CUDA
    tensors (contiguous int64, read as they are: the wrapper allocates the
    output and launches, nothing else), the plain version
    (``group_place``) for CPU tensors.  A row wider than 82 words raises
    AssertionError on both, where ``pack_groups_pallas`` asserts."""
    B, m, capw1 = sbuf.shape
    if gw.shape != (B, m):
        raise ValueError("pack_groups: gw must have shape [B, m]")
    if capw1 > PACK_MAX_CAPW1:
        raise AssertionError(f"pack_groups: capw + 1 = {capw1} is past "
                             f"{PACK_MAX_CAPW1}, as pack_groups_pallas "
                             f"asserts")
    if sbuf.device.type == "cpu":
        return group_place(sbuf, gw, nwords)
    if sbuf.dtype != torch.int64 or gw.dtype != torch.int64 \
            or not (sbuf.is_contiguous() and gw.is_contiguous()):
        raise ValueError("pack_groups: sbuf and gw must be contiguous int64 "
                         "on CUDA")
    out = torch.empty(B, nwords, dtype=torch.int64, device=sbuf.device)
    pack_groups_into(sbuf, gw, out)
    _build.count_launch(pack_groups)
    return out


reset_launch_counts()
