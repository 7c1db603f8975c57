"""The lean min-cost-DP compress tier, on the CUDA device.

Counterpart of the lean tier of ``libdeflate_tpu/compress/tpu_optimal.py``:
the ladders and cost constants (lines 75-97), ``_literal_costs`` with
``sample=32`` (135-179), ``_dist_cost`` (182), ``_seed_lc_len``
(191-207), ``_commit`` (349) and ``compress_chunks_lean_pallas``
(733-754), which is ``_compress_chunks_optimal_pallas`` (524-684) at
``passes=1`` with the dense ladder, raw candidate C, no second
relaxation round, 11-bit codes and a 1/32 literal sample.

``_dp_parse`` (244-346), the XLA DP, has its counterpart in
``kernels.dp_parse_plain``, the plain version of the DP kernel; the
per-position byte-cost select tree (``_byte_table_select``) becomes
indexing.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import from_numpy_batch
from . import kernels
from .bits import bsr
from .dynamic import batched_hist, emit_dynamic_block
from .pipeline import commit_items, parse_candidates_lean

DP_SEG = 1024
BIT = 16
LEN_SYM_COST = 7 * BIT
DIST_SYM_COST = 5 * BIT
LIT_SAMPLE = 32


def _seed_lc_len() -> np.ndarray:
    """Seeded per-length match cost table [259]: LEN_SYM_COST + 16*extra;
    lengths < 3 are not matches."""
    f = np.arange(259)
    l1 = np.maximum(f - 3, 1)
    k = np.maximum(np.int64(np.floor(np.log2(l1))), 0)
    band_slot = 4 * k - 4 + ((l1 >> np.maximum(k - 2, 0)) & 3)
    slot = np.where(f <= 10, np.maximum(f - 3, 0),
                    np.where(f >= 258, 28, band_slot))
    extra = np.where((slot < 8) | (slot >= 28), 0, (slot >> 2) - 1)
    out = (LEN_SYM_COST + BIT * extra).astype(np.int32)
    out[:3] = 1 << 28
    return out


SEED_LC_LEN = _seed_lc_len()


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v))


def fma_f32(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 a*b + c.  The product is exact in
    float64; the float64 sum is rounded to odd (TwoSum error, then a
    nudge off an even last bit), so the final rounding to float32 cannot
    round twice."""
    a, b, c = (torch.as_tensor(t).to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# float32 constants of the natural-log kernel that XLA's CPU backend
# emits (the Cephes polynomial of Eigen's plog), and float32(1/ln 2)
_LOG_P = [float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4", "0x1.23d37ep-3",
    "0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.de4a34p-4", "-0x1.555cap-3",
    "0x1.555554p-2")]
_LOG_Q1 = float.fromhex("-0x1.bd0106p-13")
_LOG_Q2 = float.fromhex("0x1.63p-1")
_INV_LN2 = float(np.float32(1.44269502))


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, bit-equal to
    ``jnp.log`` as XLA compiles it for an x86 CPU with FMA: the same
    polynomial, operation order and multiply-add contractions.  The JAX
    reference's literal costs go through it; ``torch.log`` and
    ``torch.log2`` differ from it in the last bit for some integers."""
    one = _f32(1.0)
    x = torch.clamp(x.to(torch.float32), min=float(np.float32(2.0 ** -126)))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.70710677)
    xx = (m - one) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    p = [_f32(v) for v in _LOG_P]
    z = xx * xx
    x3 = z * xx
    a = fma_f32(fma_f32(xx, p[0], p[1]), xx, p[6])
    b = fma_f32(fma_f32(xx, p[2], p[3]), xx, p[7])
    c = fma_f32(fma_f32(xx, p[4], p[5]), xx, p[8])
    t = fma_f32(fma_f32(a, x3, b), x3, c)
    y = fma_f32(t, x3, _f32(_LOG_Q1) * e)
    r = fma_f32(_f32(-0.5), z, xx) + y
    return fma_f32(_f32(_LOG_Q2), e, r)


def literal_cost_table(bp: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """[B, 256] literal costs (1/16 bit) from the histogram of every
    32nd byte: -16*log2(p) clamped to [1, 15] bits, 15 bits for
    unseen bytes (``_literal_costs``' seeding branch).

    XLA compiles the reference's ``log2(total) - log2(h)`` to
    ``log(total)*c - log(h)*c`` with c = float32(1/ln 2), the second
    product contracted into a multiply-add; the table repeats that
    arithmetic exactly (``xla_log_f32``, ``fma_f32``)."""
    n_s = bp.shape[1] // LIT_SAMPLE
    pos = torch.arange(n_s, device=bp.device)
    sym = torch.where(pos * LIT_SAMPLE < length[:, None],
                      bp[:, ::LIT_SAMPLE][:, :n_s].to(torch.int64), 256)
    h = batched_hist(sym, 256)
    return seed_costs(h, torch.clamp(h.sum(1), min=1))


def seed_costs(h: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Cost of counts h [R, K] out of total [R]: round(16*log2(total/h))
    clamped to [16, 240], 240 where h is 0."""
    inv_ln2 = _f32(_INV_LN2).to(h.device)
    lt = xla_log_f32(total.to(torch.float32)) * inv_ln2
    lh = xla_log_f32(torch.clamp(h, min=1).to(torch.float32))
    bits = fma_f32(-lh, inv_ln2, lt[:, None])
    cost = torch.clamp(torch.round(bits * BIT).to(torch.int64),
                       BIT, 15 * BIT)
    return torch.where(h > 0, cost, 15 * BIT)


def literal_costs(bp: torch.Tensor, length: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """Per-position literal cost: table[byte] before ``length``, else 0."""
    pos = torch.arange(bp.shape[1], device=bp.device)
    c_at = table.gather(1, bp.to(torch.int64))
    return torch.where(pos < length[:, None], c_at, 0)


def dist_cost(dist: torch.Tensor) -> torch.Tensor:
    """Seeded offset cost DIST_SYM_COST + 16 * extra_bits (``_dist_cost``)."""
    o1 = torch.clamp(dist.to(torch.int64), min=1) - 1
    k = bsr(torch.clamp(o1, min=1))
    return DIST_SYM_COST + BIT * torch.clamp(k - 1, min=0)


def commit(span, dist, pos, length, S_eff: int):
    """Replay the DP's chosen chain with same-distance merging
    (``_commit``).  Returns (commit_match, commit_lit, eff)."""
    return commit_items(span, (span >= 3) & (dist > 0), dist, pos, length,
                        S_eff)


def compress_chunks_lean(bufs, lengths, bfinal, device=None,
                         on_stage: Callable[[str], None] | None = None):
    """Single-cost-pass lean DP tier: uint8[B, N], int[B], bool[B] ->
    (words int32[B, W] holding the uint32 bit patterns, total_bits
    int64[B]).  Each chunk becomes a byte-aligned raw-DEFLATE fragment
    (one dynamic or static block plus an empty stored block carrying
    BFINAL).  Runs on CUDA unless ``device`` names another device.

    ``on_stage(name)``, when given, is called as each stage begins and
    with ``"end"`` after the last, for per-stage timing."""
    mark = on_stage or (lambda name: None)
    bufs, lengths, bfinal = from_numpy_batch(bufs, lengths, bfinal, device)
    n = bufs.shape[1]

    mark("candidates")
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = parse_candidates_lean(
        bufs, lengths)
    n_pad = bp.shape[1]
    S_eff = DP_SEG if (n_pad % DP_SEG == 0 and n_pad >= DP_SEG) else n_pad

    mark("costs")
    cost_lit = literal_costs(bp, lengths, literal_cost_table(bp, lengths))
    cds = [dist_cost(d) for d in (dA, dB, dC, d3)]
    lc_len = torch.as_tensor(SEED_LC_LEN, device=bp.device)

    mark("dp")
    span, dist = kernels.dp_parse(
        cost_lit, lenA, dA, cds[0], lenB, dB, cds[1], lenC, dC, cds[2],
        d3, cds[3], lc_len, S_eff)

    mark("commit")
    commit_match, commit_lit, eff = commit(span, dist, pos, lengths, S_eff)
    words, total_bits = emit_dynamic_block(bp, bfinal, commit_match,
                                           commit_lit, eff, dist, n,
                                           mark=mark)
    mark("end")
    return words, total_bits
