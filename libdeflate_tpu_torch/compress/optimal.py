"""The min-cost-DP compress tiers, on the CUDA device.

Counterpart of ``libdeflate_tpu/compress/tpu_optimal.py``: the ladders
and cost constants (lines 72-97), ``_literal_costs`` (135-179, every
sample, with ``table`` and ``cache``), ``_dist_cost`` (182),
``_seed_lc_len`` (191-207), ``_SHORT_BIAS16`` (217), ``_lc_len_from_lens``
(220), ``_take30`` (232), ``_commit`` (349), ``_code_lens_from_items``
(358), ``parse_chunk_optimal`` and ``compress_chunk_optimal`` (383-482,
with ``row_lit1``; batched as ``compress_chunks_optimal_with``),
``_compress_chunks_optimal_pallas`` (524-684, with every keyword, as
``compress_chunks_optimal_pallas_with``), and the entries
``compress_chunks_optimal``, ``compress_chunks_optimal2``,
``compress_chunks_optimal_deep`` (485-521) with their ``_pallas`` twins
(687-716), ``compress_chunks_optfast_pallas`` (719) and
``compress_chunks_lean_pallas`` (733), all through one function,
``_compress_dp``, which mirrors ``_compress_chunks_optimal_pallas``:
candidates, seed costs (or pass 1's mean literal cost a chunk or a row),
the DP kernel, commit, then each further cost pass (code lengths from the
items, re-translated costs, the DP and commit again), then the emission
(one block or several a chunk, premerged in groups of 128 items or
another size).

``_dp_parse`` (244-346), the XLA DP, has its counterpart in
``kernels.dp_parse_plain``, the plain version of the DP kernel; the
per-position select trees (``_byte_table_select``, ``_take30``) become
indexing.  Where the XLA entries and the ``_pallas`` twins differ, the
port follows the XLA ones: in a further cost pass every DP lane reads its
own chunk's match-cost table (the Pallas kernel reads one table a
1024-lane block, the same only where a chunk fills whole blocks), and
``compress_chunks_optimal_with`` ignores ``lit_sample`` as
``parse_chunk_optimal`` does (``_compress_chunks_optimal_pallas``
honours it).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from ..device import constant, from_numpy_batch
from ..utils.profiling import stage_marks
from . import kernels
from .bits import GROUP, STRIDES, bsr, length_slot, offset_slot
from .dynamic import (
    MAX_CODE_LEN_DEEP,
    batched_hist,
    build_code_lens_pair,
    code_hists,
    emit_dynamic_block,
    item_sym,
)
from .kernels import LEN_LADDER, LEN_LADDER_DENSE2
from .pipeline import LEAN_CANDIDATES, commit_items, parse_candidates

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
# the passes >= 2 tiers' seed bias: 3 bits off matches of length <= 8
SHORT_BIAS16 = np.where(np.arange(259) <= 8, 3 * BIT, 0).astype(np.int32)


def seed_lc_len(match_bias16=0) -> np.ndarray:
    """Pass 1's [259] match costs: SEED_LC_LEN less ``match_bias16`` (a
    scalar or a [259] table), at least 1, lengths < 3 not matches."""
    lc = np.maximum(SEED_LC_LEN - np.asarray(match_bias16, np.int64), 1)
    return np.where(np.arange(259) < 3, 1 << 28, lc).astype(np.int32)


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


# xla_log_f32 of the whole numbers below a power of two, by device and
# size: made once, finished before any stream reads them, never freed
_whole_logs: dict[tuple[torch.device, int], torch.Tensor] = {}
_whole_logs_lock = threading.Lock()


def whole_logs(most: int, dev: torch.device) -> torch.Tensor:
    """``xla_log_f32`` of 0, 1, ... at least ``most`` as one float32
    table on ``dev`` (0's entry unused), so that the seed costs of counts
    up to ``most`` read their logarithms: a few ops where computing them
    takes some 400, which the mesh's shard threads each pay for."""
    key = (dev, 1 << max(most, 1).bit_length())
    table = _whole_logs.get(key)
    if table is None:
        with _whole_logs_lock:
            table = _whole_logs.get(key)
            if table is None:
                table = xla_log_f32(torch.arange(key[1], device=dev).to(
                    torch.float32))
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                _whole_logs[key] = table
    return table


def literal_hist_rows(bp: torch.Tensor, length: torch.Tensor,
                      sample: int = 1) -> torch.Tensor:
    """The per-row byte histogram that ``_literal_costs`` keeps as its
    cache: every ``sample``-th byte before ``length`` (class 256 past
    it and in the padding), split into max(n_s // 65536, 1) equal
    contiguous rows, [B, rows, 257]."""
    B = bp.shape[0]
    n_s = bp.shape[1] // sample
    pos = torch.arange(n_s, device=bp.device)
    sym = torch.where(pos * sample < length.reshape(B, 1),
                      bp[:, ::sample][:, :n_s].to(torch.int64), 256)
    rows = max(n_s // 65536, 1)
    n_rs = -(-n_s // (rows * 128)) * (rows * 128)
    sym = torch.nn.functional.pad(sym, (0, n_rs - n_s), value=256)
    return batched_hist(sym.reshape(B * rows, n_rs // rows),
                        257).reshape(B, rows, 257)


def literal_cost_table(bp: torch.Tensor, length: torch.Tensor,
                       sample: int = LIT_SAMPLE,
                       cache: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 256] literal costs (1/16 bit) from the histogram of every
    ``sample``-th byte (or of a given ``literal_hist_rows`` cache):
    -16*log2(p) clamped to [1, 15] bits, 15 bits for unseen bytes
    (``_literal_costs``' seeding branch).

    XLA compiles the reference's ``log2(total) - log2(h)`` to
    ``log(total)*c - log(h)*c`` with c = float32(1/ln 2), the second
    product contracted into a multiply-add; the table repeats that
    arithmetic exactly (``xla_log_f32``, ``fma_f32``)."""
    if cache is None:
        cache = literal_hist_rows(bp, length, sample)
    h = cache.sum(1)[:, :256]
    return seed_costs(h, torch.clamp(h.sum(1), min=1), most=bp.shape[1])


def seed_costs(h: torch.Tensor, total: torch.Tensor,
               most: int) -> torch.Tensor:
    """Cost of counts h [R, K] out of total [R]: round(16*log2(total/h))
    clamped to [16, 240], 240 where h is 0.  ``most`` bounds every count
    (the logarithms come from ``whole_logs``' table)."""
    inv_ln2 = constant(np.float32(_INV_LN2), np.float32, h.device)
    logs = whole_logs(most, h.device)
    lt = logs[total] * inv_ln2
    lh = logs[torch.clamp(h, min=1)]
    bits = fma_f32(-lh, inv_ln2, lt[:, None])
    cost = torch.clamp(torch.round(bits * BIT).to(torch.int64),
                       BIT, 15 * BIT)
    return torch.where(h > 0, cost, 15 * BIT)


def mean_literal_costs(cache: torch.Tensor, n_pad: int,
                       per_row: bool) -> torch.Tensor:
    """Pass 1's literal cost as a mean: the seeded cost of each byte
    weighted by its count and floor-divided by the count, over the whole
    ``literal_hist_rows`` cache [B, rows, 257] of a chunk (``flat_lit1``)
    or over each row (``row_lit1``: a row is a contiguous 64 KiB span of
    the sampled bytes), broadcast over the chunk's or row's [B, n_pad]
    positions, past ``length`` too (``tpu_optimal.py:412-422, 575-611``)."""
    h = cache[..., :256]
    if not per_row:
        h = h.sum(1, keepdim=True)
    B, m, _ = h.shape
    total = torch.clamp(h.sum(2), min=1)
    c = seed_costs(h.reshape(B * m, 256), total.reshape(B * m), most=n_pad)
    mean = (h * c.reshape(B, m, 256)).sum(2) // total
    return mean.repeat_interleave(n_pad // m, dim=1)


def literal_costs(bp: torch.Tensor, length: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """Per-position literal cost: table[byte] before ``length``, else 0."""
    pos = torch.arange(bp.shape[1], device=bp.device)
    c_at = table.gather(1, bp.to(torch.int64))
    return torch.where(pos < length[:, None], c_at, 0)


def literal_costs_with(bp: torch.Tensor, length: torch.Tensor,
                       table: torch.Tensor | None = None,
                       cache: torch.Tensor | None = None, sample: int = 1):
    """``_literal_costs``, batched: (per-position literal costs [B,
    n_pad], the row histogram cache [B, rows, 257] or the given one).
    With ``table`` ([B, 256], e.g. code lengths * 16) the bytes translate
    through it, 14 bits where it is 0, and no histogram is taken."""
    if table is None:
        if cache is None:
            cache = literal_hist_rows(bp, length, sample)
        table = literal_cost_table(bp, length, cache=cache)
    else:
        table = torch.where(table > 0, table, 14 * BIT)
    return literal_costs(bp, length, table), cache


def dist_cost(dist: torch.Tensor) -> torch.Tensor:
    """Seeded offset cost DIST_SYM_COST + 16 * extra_bits (``_dist_cost``)."""
    o1 = torch.clamp(dist.to(torch.int64), min=1) - 1
    k = bsr(torch.clamp(o1, min=1))
    return DIST_SYM_COST + BIT * torch.clamp(k - 1, min=0)


def lc_len_from_lens(lit_lens: torch.Tensor) -> torch.Tensor:
    """Per-length match costs [B, 259] from litlen code lengths [B, 286]
    (``_lc_len_from_lens``): the length symbol's bits, 14 for an unused
    symbol, plus the extra bits, in 1/16 bit; lengths < 3 not matches."""
    f = torch.arange(259, device=lit_lens.device)
    lslot, _, lextra = length_slot(torch.clamp(f, min=3))
    sym_len = lit_lens[:, 257 + lslot].to(torch.int64)
    out = torch.where(sym_len > 0, sym_len, 14) * BIT + BIT * lextra
    return torch.where(f < 3, 1 << 28, out)


def take30(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``_take30``: table [B, 30] at idx [B, n], the select tree's reading
    of the low five bits (30 and 31 read entry 29)."""
    return table.gather(1, torch.clamp(idx & 31, max=29))


def dist_cost_from(table: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """A further pass's offset cost: the offset slot's cost from
    ``table`` [B, 30] plus 16 per extra bit."""
    oslot, _, oextra = offset_slot(torch.clamp(dist, min=1))
    return take30(table, oslot) + BIT * oextra


def code_lens_from_items(bp, commit_match, commit_lit, eff, dist):
    """Litlen and offset code lengths [B, 286], [B, 30] of a pass's
    committed items (``_code_lens_from_items``): a match's length symbol
    at its position and its offset symbol one position after, a literal's
    byte; end-of-block counted once, and symbols 0 (litlen) and 0, 1
    (offset) forced to 1 where unused; 15-bit codes, 16 refinement
    passes."""
    lslot = length_slot(torch.clamp(eff, min=3))[0]
    oslot = offset_slot(torch.clamp(dist, min=1))[0]
    hist_lit, hist_dist = code_hists(item_sym(bp, commit_match, commit_lit,
                                              oslot, lslot))
    lit_lens, dist_lens, _, _ = build_code_lens_pair(
        hist_lit, hist_dist, 16, MAX_CODE_LEN_DEEP)
    return lit_lens, dist_lens


def commit(span, dist, pos, length, S_eff: int):
    """Replay the DP's chosen chain with same-distance merging
    (``_commit``).  Returns (commit_match, commit_lit, eff)."""
    return commit_items(span, (span >= 3) & (dist > 0), dist, pos, length,
                        S_eff)


def _compress_dp(bufs, lengths, bfinal, device, on_stage, *,
                 candidates: dict, passes: int, ladder, lit_sample: int,
                 match_bias16, refine: int, S: int = DP_SEG,
                 lit1: str | None = None, blocks: int = 1,
                 pm_group: int = GROUP):
    """The DP tiers' pipeline (``_compress_chunks_optimal_pallas``):
    candidates (``parse_candidates(**candidates)``), seed costs (literal
    histogram every ``lit_sample``-th byte, or with ``lit1`` "flat" or
    "row" its mean a chunk or a row, ``mean_literal_costs``; seeded
    offset costs; the seed match costs less ``match_bias16``), the DP
    kernel over ``ladder`` and the commit; then ``passes - 1`` times code
    lengths from the items, literal, match and offset costs from them
    (one match-cost table a chunk), the DP and the commit again; then
    ``blocks`` dynamic blocks a chunk with ``refine`` refinement passes
    (15-bit codes if any, else 11-bit), premerged in groups of
    ``pm_group`` items.  ``on_stage(name)`` marks each stage's start and
    the end; a further pass's stages are named with its number
    ("dp_2").  With a profiler session on, each stage is the range
    ``stage.<name>`` (``utils.profiling.stage_marks``)."""
    with stage_marks(on_stage) as mark:
        bufs, lengths, bfinal = from_numpy_batch(bufs, lengths, bfinal,
                                                 device)
        n = bufs.shape[1]

        mark("candidates")
        bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = parse_candidates(
            bufs, lengths, **candidates)
        n_pad = bp.shape[1]
        S_eff = S if (n_pad % S == 0 and n_pad >= S) else n_pad
        dists = (dA, dB, dC, d3)

        mark("costs")
        if lit1:
            cost_lit = mean_literal_costs(
                literal_hist_rows(bp, lengths, lit_sample), n_pad,
                lit1 == "row")
        else:
            cost_lit, _ = literal_costs_with(bp, lengths, sample=lit_sample)
        cds = [dist_cost(d) for d in dists]
        lc_len = constant(seed_lc_len(match_bias16), np.int32, bp.device)
        for k in range(1, passes + 1):
            if k > 1:
                mark(f"code_lens_{k}")
                lit_lens, dist_lens = code_lens_from_items(bp, cm, cl, eff,
                                                           dist)
                mark(f"costs_{k}")
                cost_lit, _ = literal_costs_with(
                    bp, lengths, table=lit_lens[:, :256] * BIT)
                lc_len = lc_len_from_lens(lit_lens)
                dtab = torch.where(dist_lens > 0, dist_lens, 14) * BIT
                cds = [dist_cost_from(dtab, d) for d in dists]
            sfx = "" if k == 1 else f"_{k}"
            mark("dp" + sfx)
            span, dist = kernels.dp_parse(
                cost_lit, lenA, dA, cds[0], lenB, dB, cds[1], lenC, dC,
                cds[2], d3, cds[3], lc_len, S_eff, ladder)
            mark("commit" + sfx)
            cm, cl, eff = commit(span, dist, pos, lengths, S_eff)
        words, total_bits = emit_dynamic_block(
            bp, bfinal, cm, cl, eff, dist, n, refine, mark, blocks, pm_group)
        mark("end")
        return words, total_bits


# each entry's configuration, as the JAX entries set it
TIERS = {
    "lean": dict(candidates=LEAN_CANDIDATES, passes=1,
                 ladder=LEN_LADDER_DENSE2, lit_sample=LIT_SAMPLE,
                 match_bias16=0, refine=0),
    "optfast": dict(candidates=LEAN_CANDIDATES, passes=2,
                    ladder=LEN_LADDER_DENSE2, lit_sample=1,
                    match_bias16=SHORT_BIAS16, refine=16),
    "optimal": dict(candidates={}, passes=1, ladder=LEN_LADDER,
                    lit_sample=1, match_bias16=0, refine=16),
    "optimal2": dict(candidates={}, passes=2, ladder=LEN_LADDER,
                     lit_sample=1, match_bias16=0, refine=16),
    "deep": dict(candidates=dict(depth=12, two_pass=True, hash3=True,
                                 wide_window=False, content_doublings=2),
                 passes=3, ladder=LEN_LADDER_DENSE2, lit_sample=1,
                 match_bias16=SHORT_BIAS16, refine=16),
}


# the mesh ladder's chunk compressor at levels 5-7, 8-9 and 10-12
# (parallel/mesh.py:67-81), as ``compress_chunks_optimal_with`` keywords
MESH_LEVEL_OPTIONS = {
    5: dict(passes=1, use_content=False, use_wide=False,
            ladder=LEN_LADDER_DENSE2, ext_c=False, strides2=(),
            lit_sample=32),
    8: dict(passes=2, ladder=LEN_LADDER_DENSE2, match_bias16=SHORT_BIAS16),
    10: dict(depth=12, two_pass=True, hash3=True, passes=2,
             ladder=LEN_LADDER_DENSE2, match_bias16=SHORT_BIAS16),
}


def compress_chunks_lean(bufs, lengths, bfinal, device=None,
                         on_stage: Callable[[str], None] | None = None):
    """Single-cost-pass lean DP tier (``compress_chunks_lean_pallas``):
    uint8[B, N], int[B], bool[B] -> (words int32[B, W] holding the uint32
    bit patterns, total_bits int64[B]).  Each chunk becomes a
    byte-aligned raw-DEFLATE fragment (one dynamic or static block plus
    an empty stored block carrying BFINAL).  Runs on CUDA unless
    ``device`` names another device.

    ``on_stage(name)``, when given, is called as each stage begins and
    with ``"end"`` after the last, for per-stage timing."""
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        **TIERS["lean"])


def compress_chunks_optfast(bufs, lengths, bfinal, device=None,
                            on_stage: Callable[[str], None] | None = None):
    """Lean two-cost-pass DP tier (``compress_chunks_optfast_pallas``):
    the lean candidates, the dense ladder, the short-match seed bias, a
    refined second cost pass, 15-bit codes.  Same contract as
    ``compress_chunks_lean``."""
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        **TIERS["optfast"])


def compress_chunks_optimal(bufs, lengths, bfinal, device=None,
                            on_stage: Callable[[str], None] | None = None):
    """DP tier at every ``compress_chunk_optimal`` default
    (``compress_chunks_optimal`` and ``_pallas``): the content pass, 32-byte
    payloads, C in the relaxation, two relaxation rounds, LEN_LADDER, one
    cost pass.  Same contract as ``compress_chunks_lean``."""
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        **TIERS["optimal"])


def compress_chunks_optimal2(bufs, lengths, bfinal, device=None,
                             on_stage: Callable[[str], None] | None = None):
    """``compress_chunks_optimal`` with a refined second cost pass
    (``compress_chunks_optimal2`` and ``_pallas``)."""
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        **TIERS["optimal2"])


def compress_chunks_optimal_deep(
        bufs, lengths, bfinal, device=None,
        on_stage: Callable[[str], None] | None = None):
    """The deep DP tier (``compress_chunks_optimal_deep`` and ``_pallas``):
    depth 12, the rescue pass, hash3, 64 KiB windows, two suffix-rank
    doublings in the content pass, the dense ladder, the short-match
    bias, three cost passes.  Same contract as ``compress_chunks_lean``."""
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        **TIERS["deep"])


def candidate_options(**options) -> dict:
    """``parse_candidates``' keywords of an entry's options: the windows
    64 KiB with ``two_pass`` or ``hash3``, 128 KiB otherwise."""
    return dict(options, wide_window=not (options["two_pass"]
                                          or options["hash3"]))


def compress_chunks_optimal_with(bufs, lengths, bfinal, device=None,
                                 on_stage: Callable[[str], None] | None = None,
                                 depth: int = 6, two_pass: bool = False,
                                 hash3: bool = False, passes: int = 1,
                                 use_content: bool = True,
                                 use_wide: bool = True, ladder=LEN_LADDER,
                                 refine_passes: int = 16, S: int = DP_SEG,
                                 ext_c: bool = True, lcp: int = 16,
                                 row_lit1: bool = False, strides2=STRIDES,
                                 strides1=STRIDES, lit_sample: int = 1,
                                 content_doublings: int = 0,
                                 content_round_probes: bool = False,
                                 match_bias16=0):
    """``compress_chunk_optimal`` with keyword arguments, over a batch
    (its ``jax.vmap``), as the mesh ladder calls it at levels 5-12:
    ``parse_chunk_optimal``'s options, the windows 64 KiB with
    ``two_pass`` or ``hash3`` and 128 KiB otherwise.  ``lit_sample`` is
    accepted and ignored, as there: the seed histogram takes every byte,
    and ``row_lit1``'s 64 KiB rows are rows of every byte.  Same contract
    as ``compress_chunks_lean``."""
    candidates = candidate_options(
        depth=depth, two_pass=two_pass, hash3=hash3, use_content=use_content,
        use_wide=use_wide, ext_c=ext_c, lcp=lcp, strides2=strides2,
        strides1=strides1, content_doublings=content_doublings,
        content_round_probes=content_round_probes)
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        candidates=candidates, passes=passes, ladder=ladder,
                        lit_sample=1, match_bias16=match_bias16,
                        refine=refine_passes, S=S,
                        lit1="row" if row_lit1 else None)


def compress_chunks_optimal_pallas_with(
        bufs, lengths, bfinal, device=None,
        on_stage: Callable[[str], None] | None = None, *, depth: int,
        two_pass: bool, hash3: bool, passes: int = 1,
        use_content: bool = True, use_wide: bool = True, ladder=LEN_LADDER,
        refine: int = 16, flat_lit1: bool = False, row_lit1: bool = False,
        ext_c: bool = True, lcp8: bool = False, lcp: int = 16,
        strides2=STRIDES, strides1=STRIDES, lit_sample: int = 1,
        pm_group: int = GROUP, content_doublings: int = 0,
        content_round_probes: bool = False, match_bias16=0,
        emit_blocks: int = 1):
    """``_compress_chunks_optimal_pallas`` with every keyword under its
    own name, as ``scripts/`` calls it: the candidates' options (``lcp8``
    is ``lcp`` 8), the seed histogram of every ``lit_sample``-th byte,
    pass 1's literal cost as its mean a chunk (``flat_lit1``) or a 64 KiB
    row of the sampled bytes (``row_lit1``), ``passes`` cost passes over
    ``ladder``, ``refine`` refinement passes, the premerge in groups of
    ``pm_group`` items and ``emit_blocks`` blocks a chunk.  Where this
    path and the XLA entries differ the port follows the XLA ones (one
    match-cost table a chunk in a further pass; the same bits at 1 MiB
    chunks).  A ``pm_group`` that does not divide the item stream raises
    TypeError, a premerge row wider than 82 words AssertionError, and
    ``emit_blocks`` blocks not of a multiple of 1024 positions
    AssertionError, where the reference fails.  Same contract as
    ``compress_chunks_lean``."""
    candidates = candidate_options(
        depth=depth, two_pass=two_pass, hash3=hash3, use_content=use_content,
        use_wide=use_wide, ext_c=ext_c, lcp=8 if lcp8 else lcp,
        strides2=strides2, strides1=strides1,
        content_doublings=content_doublings,
        content_round_probes=content_round_probes)
    lit1 = "flat" if flat_lit1 else "row" if row_lit1 else None
    return _compress_dp(bufs, lengths, bfinal, device, on_stage,
                        candidates=candidates, passes=passes, ladder=ladder,
                        lit_sample=lit_sample, match_bias16=match_bias16,
                        refine=refine, lit1=lit1, blocks=emit_blocks,
                        pm_group=pm_group)
