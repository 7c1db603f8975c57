"""Compress pipeline stages on [B, n] tensors: the DP tiers' candidates
and the greedy/lazy tiers' parser.

Counterpart of ``libdeflate_tpu/compress/tpu_pipeline.py``:
``_static_litlen_code`` (107), ``_sorted_matchfind`` (192-395; its
``return_triple`` branch over wide payloads is
``sorted_matchfind_triple``), ``_row_cummax`` (397, as ``cummax``),
``_content_sorted_matchfind`` (410-538), ``_pay_better`` (541),
``_pool_probe`` (549), ``_parse_candidates`` (1086-1235, as
``parse_candidates``), ``_exclusive_bit_offsets`` (828),
``_group_premerge`` (861), ``_hash3_matchfind`` (934), ``_parse_chunk``
(965-1083, as ``greedy_candidates`` and ``commit_items``),
``compress_chunk_static`` and ``compress_chunks_static`` (1238-1305) and
``device_stream_to_bytes`` (1308).  The stages call the kernel wrappers,
which hold the rest of that file as their plain versions: the chain
extensions (``chain_kernels``), the sorted matchfind's forms that levels
0-7 run and the probe primitives (``probe_kernels``), the commit FSM
(``scan_kernels``) and the group placement (``kernels``); the constants,
``_le32_words`` and ``_segment_sizes`` are in ``bits``.

The JAX functions work on one chunk under ``vmap``; these take a leading
batch axis.  Where the TPU needed a trick the port uses the direct op:
the un-permute sort becomes a scatter by the sort's own indices, a sort
on three keys becomes two stable int64 sorts, the triangular-matmul
prefix sum becomes ``cumsum``, the log-shift running extrema become
``cummin`` and ``cummax``, the one-hot alphabet count of the minimum
match length becomes a scatter.  Every result is bit-equal to the JAX
one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import from_numpy_batch
from ..utils.profiling import stage_marks
from . import chain_kernels as ck
from . import kernels, scan_kernels
from . import probe_kernels as pk
from .bits import (DEPTH, FSM_SEG, GROUP, GROUP_CAPW, HASH_ORDER, M32,
                   MAX_LEN, MIN_MATCH, MULT, STRIDES, WINDOW, ahead, behind,
                   bsr, le32_words, length_slot, offset_slot, rev, rev16,
                   seg_key_params, segment_sizes, to_i32)
from .probe_kernels import (best_two, pack_inv, pay, sorted_segments, unpay,
                            unpermute, word_lcp)


def sorted_matchfind(h, w, w4, w8, w12, seg: int, depth: int = 2,
                     wide_ext: bool = False):
    """``_sorted_matchfind`` without ``return_pair``/``return_triple``: the
    nearest same-hash candidates per position from one sort of every
    ``seg``-position segment, ``depth`` probes each, 16-byte payloads
    (``w8`` and ``w12`` given) or 8-byte ones (either None).  Without
    ``wide_ext`` the best probe (``probe_kernels.sorted_best``) is
    chain-extended (``chain_kernels.chain_extend``); with it the best and
    the best at another distance are extended together
    (``chain_kernels.chain_extend2``).  Returns (len, dist) [B, n].  The
    compress paths reach the first form through
    ``probe_kernels.segment_probe``."""
    ws = (w, w4) if w8 is None or w12 is None else (w, w4, w8, w12)
    if not wide_ext:
        return ck.chain_extend(*pk.sorted_best(h, ws, seg, depth))
    order, probe = sorted_segments(h, ws, seg)
    pays = [pack_inv(*probe(d)) for d in range(1, depth + 1)]
    a, b = best_two(pays)
    pa, pb = unpermute(order, h.shape, pay(*a), pay(*b))
    return ck.chain_extend2(*unpay(pa), *unpay(pb))


def sorted_matchfind_triple(h, ws, seg: int, depth: int = DEPTH):
    """``_sorted_matchfind``'s ``return_triple`` branch with wide payloads
    (``ws`` the eight words w, w4, ..., w28: an LCP of up to 32 bytes
    plus the remainder): the best, the best at another distance and the
    nearest same-hash candidate per position, each a raw word-granular
    (mlen, dist, fine) [B, n] triple, C unpacked in full."""
    order, probe = sorted_segments(h, ws, seg)
    c = probe(1)
    pays = [pack_inv(*c)] + [pack_inv(*probe(d))
                             for d in range(2, depth + 1)]
    a, b = best_two(pays)
    return [unpay(x) for x in unpermute(order, h.shape, pay(*a), pay(*b),
                                        pay(*c))]


def _sort3(ka, kb, kc):
    """Per row of [rows, seg] keys, the order sorting by (ka, kb, kc)
    (``lax.sort`` with three keys): ka and kb below 2**32, kc below 2**18
    and unique within a row.  A sort by (kb, kc) packed into one int64,
    then a stable sort by ka."""
    o1 = torch.argsort((kb << 18) | kc, dim=1)
    o2 = torch.sort(ka.gather(1, o1), dim=1, stable=True).indices
    return o1.gather(1, o2)


def _pool_probe(sjunk, slp, sws, depth: int):
    """+-depth neighbour probes over one sorted order (``_pool_probe``):
    the packed (best, best at a distinct distance) candidate pair per
    sorted slot, pay = mlen<<18 | fine<<16 | dist.  ``sjunk`` flags the
    junk slots, ``slp`` holds each slot's position, ``sws`` the sorted
    payload words."""
    seg = slp.shape[1]
    col = torch.arange(seg, device=slp.device)[None, :]
    z = torch.zeros_like(slp)
    mlen, dist, fine, mlen2, dist2, fine2 = (z,) * 6
    for d in list(range(1, depth + 1)) + [-k for k in range(1, depth + 1)]:
        same = ((sjunk == 0) & (torch.roll(sjunk, d, 1) == 0)
                & (col >= d if d > 0 else col < seg + d))
        dist_i = slp - torch.roll(slp, d, 1)
        ok = same & (dist_i >= 1) & (dist_i <= WINDOW)
        m2, f2, eq4 = word_lcp(ok, [x ^ torch.roll(x, d, 1) for x in sws])
        d2 = torch.where(eq4, dist_i, 0)
        better = ((m2 > mlen) | ((m2 == mlen) & (f2 > fine))
                  | ((m2 == mlen) & (f2 == fine) & (d2 < dist) & (d2 > 0)))
        cm = torch.where(better, mlen, m2)
        cd = torch.where(better, dist, d2)
        cf = torch.where(better, fine, f2)
        nbd = torch.where(better, d2, dist)
        upd2 = ((cd != nbd) & (cd != 0)
                & ((cm > mlen2) | ((cm == mlen2) & (cf > fine2))))
        mlen2 = torch.where(upd2, cm, mlen2)
        dist2 = torch.where(upd2, cd, dist2)
        fine2 = torch.where(upd2, cf, fine2)
        mlen = torch.where(better, m2, mlen)
        dist = torch.where(better, d2, dist)
        fine = torch.where(better, f2, fine)
    return pay(mlen, dist, fine), pay(mlen2, dist2, fine2)


def pay_better(x, y):
    """Is packed candidate x (mlen<<18 | fine<<16 | dist) better than y
    (``_pay_better``): longer, then a longer remainder, then a smaller
    nonzero distance."""
    dx, dy = x & 0xFFFF, y & 0xFFFF
    return ((x >> 16) > (y >> 16)) | (((x >> 16) == (y >> 16)) & (dx < dy)
                                      & (dx > 0))


def content_sorted_matchfind(h, w, w4, w8, w12, seg: int, depth: int = 6,
                             wide=(), doublings: int = 0,
                             round_probes: bool = False):
    """The content-ordered candidate pass (``_content_sorted_matchfind``):
    every ``seg``-position segment sorted by (hash, the next 17 content
    bits), then bytes 6..9 in byte order, then position, so that suffixes
    sharing long prefixes sit side by side; with ``doublings`` each round
    first re-ranks by (rank, rank h ahead), h = 10, 20, ...  With
    ``round_probes`` each round's order is probed too (16-byte payloads)
    and its pools are merged into the final one, round by round, A then
    B, by ``pay_better``; as in the reference, that merge can leave A and
    B at one distance.  Returns the raw (mlen, dist, fine) triples of the
    best and the best at a distinct distance of the +-depth neighbour
    probes, [B, n] each."""
    shape = h.shape
    rows = h.numel() // seg
    junk = seg_key_params(seg)[1]
    h, w, w4, w8, w12 = (x.reshape(rows, seg) for x in (h, w, w4, w8, w12))
    col = torch.arange(seg, device=h.device, dtype=torch.int64)[None, :]
    # the hash (wrapped to 32 bits, as uint32), bytes 4 and 5 and the top
    # bit of byte 6; then bytes 6..9 byte-reversed
    k1 = (((h << 17) & M32) | ((w4 & 0xFF) << 9) | (((w4 >> 8) & 0xFF) << 1)
          | ((w4 >> 23) & 1))
    w6 = (w4 >> 16) | ((w8 << 16) & M32)
    k2 = (((w6 & 0xFF) << 24) | ((w6 & 0xFF00) << 8) | ((w6 >> 8) & 0xFF00)
          | (w6 >> 24))
    is_junk = h == junk
    lpj = col | (is_junk.long() << 17)
    ka, kb = k1, k2
    h_cov = 10
    round_pools = []           # each round's (pay A, pay B), position order
    for _ in range(doublings):
        order = _sort3(ka, kb, lpj)
        ska, skb = ka.gather(1, order), kb.gather(1, order)
        newg = (ska != behind(ska)) | (skb != behind(skb)) | (col == 0)
        rank_sorted = torch.cummax(torch.where(newg, col, 0), 1).values
        if round_probes:
            rpa, rpb = _pool_probe(is_junk.gather(1, order), order,
                                   [x.gather(1, order)
                                    for x in (w, w4, w8, w12)], depth)
            rank, rpa, rpb = unpermute(order, (rows, seg), rank_sorted,
                                        rpa, rpb)
            round_pools.append((rpa, rpb))
        else:
            rank, = unpermute(order, (rows, seg), rank_sorted)
        ka = rank
        kb = torch.cat([rank[:, h_cov:],
                        torch.full_like(rank[:, :h_cov], 1 << 17)], 1)
        h_cov *= 2
    if doublings:
        # junk positions stay sorted last
        ka = torch.where(is_junk, 0x7FFFFFFF, ka)
    order = _sort3(ka, kb, lpj)
    sws = [x.reshape(rows, seg).gather(1, order)
           for x in (w, w4, w8, w12, *wide)]
    pay_a, pay_b = _pool_probe(is_junk.gather(1, order), order, sws, depth)
    pa, pb = unpermute(order, (rows, seg), pay_a, pay_b)
    for q in (q for pool in round_pools for q in pool):
        better = pay_better(q, pa)
        disp = torch.where(better, pa, q)          # the displaced candidate
        keep_b = (disp & 0xFFFF) != (torch.where(better, q, pa) & 0xFFFF)
        pb = torch.where(keep_b & pay_better(disp, pb), disp, pb)
        pa = torch.where(better, q, pa)
    return unpay(pa.reshape(shape)), unpay(pb.reshape(shape))


def _row_inputs(b: torch.Tensor, length: torch.Tensor, wide_window: bool):
    """What every parser starts from: (bp the padded bytes, pos [1,
    n_pad], length [B, 1], words, the masked hash h, sort_seg, fsm_seg,
    junk_val), as ``_parse_chunk`` and ``_parse_candidates`` compute
    them."""
    B, n = b.shape
    n_pad, sort_seg, fsm_seg = segment_sizes(n, wide_window)
    junk_val = seg_key_params(sort_seg)[1]
    dev = b.device
    bp = torch.cat([b, torch.zeros(B, n_pad - n, dtype=b.dtype, device=dev)],
                   dim=1)
    pos = torch.arange(n_pad, device=dev, dtype=torch.int64)[None, :]
    length = length.to(torch.int64)[:, None]
    words = le32_words(bp)
    h = ((words * MULT) & M32) >> (32 - HASH_ORDER)
    h = torch.where(pos + MIN_MATCH <= length, h, junk_val)
    return bp, pos, length, words, h, sort_seg, fsm_seg, junk_val


def _positions(b: torch.Tensor, length: torch.Tensor, wide_window: bool):
    """``_row_inputs`` with the payload words w4, w8 and w12 after
    ``words``: (bp, pos, length, words, w4, w8, w12, h, sort_seg, fsm_seg,
    junk_val)."""
    bp, pos, length, words, *rest = _row_inputs(b, length, wide_window)
    return (bp, pos, length, words,
            *(ahead(words, k) for k in (4, 8, 12)), *rest)


def rescue_pass(h, bp, sort_seg: int, junk_val: int):
    """The half-segment-shifted second matchfind of the two-pass modes
    (depth 2, 8-byte payloads, chain-extended): every position gets at
    least half a segment of history.  ``bp`` the padded bytes.  Returns
    (len, dist) [B, n_pad], zero over the first half segment."""
    half = sort_seg // 2

    def unshift(x):
        return torch.cat([torch.zeros_like(x[:, :half]), x[:, :-half]], 1)

    hs = torch.cat([h[:, half:], torch.full_like(h[:, :half], junk_val)], 1)
    mlen_b, dist_b = ck.chain_extend(*pk.segment_probe(hs, bp, sort_seg, 2,
                                                       8, "best", half))
    return unshift(mlen_b), unshift(dist_b)


def hash3_dist(words, pos, length, sort_seg: int, junk_val: int):
    """hash3 distances ([B, n_pad], 0 for none) of the positions with
    three valid bytes before ``length`` [B, 1]."""
    h3 = (((words & 0xFFFFFF) * MULT) & M32) >> (32 - HASH_ORDER)
    h3 = torch.where(pos + 3 <= length, h3, junk_val)
    return hash3_matchfind(h3, words, sort_seg)


def parse_candidates(b: torch.Tensor, length: torch.Tensor, depth: int = 6,
                     two_pass: bool = False, hash3: bool = False,
                     wide_window: bool = True, use_content: bool = True,
                     use_wide: bool = True, ext_c: bool = True,
                     lcp: int = 16, strides2=STRIDES, strides1=STRIDES,
                     content_doublings: int = 0,
                     content_round_probes: bool = False):
    """Candidate generation for the min-cost DP (``_parse_candidates``),
    batched: b uint8 [B, n], length int [B].  The sorted matchfind's best,
    runner-up at another distance and nearest candidates (``use_wide``:
    32-byte payloads, C in full; else 16-byte ones, C packed lean); with
    ``use_content`` the content-ordered pass adds two more, and all five
    are relaxed over both stride rounds (``content_doublings`` rounds of
    suffix-rank doubling, each probed with ``content_round_probes``);
    else A and B (with ``ext_c`` also C) are relaxed over ``strides1``
    then ``strides2``.  ``lcp`` 8 or 12 drops the position pass's 16-byte
    payloads to 8-byte ones (and the wide ones with them): as in the
    reference, which keeps its deep payloads only with both w8 and w12,
    12 gives 8's candidates.  The pool keeps A
    = longest (ties: nearest), B = second-longest at another distance, C
    = nearest with len >= 4; the rescue pass (``two_pass``) merges into
    A/B on strictly longer matches; then the cap at the chunk's end and,
    with ``hash3``, the len-3 distances.

    Returns (bp, pos, lenA, dA, lenB, dB, lenC, dC, d3), each [B, n_pad]
    (pos [1, n_pad]); d3 is zero without ``hash3``."""
    (bp, pos, length, words, h, sort_seg, _,
     junk_val) = _row_inputs(b, length, wide_window)
    if use_wide or use_content:
        w4, w8, w12 = (ahead(words, k) for k in (4, 8, 12))
    wide = tuple(ahead(words, k) for k in (16, 20, 24, 28)) \
        if use_wide else ()
    if use_wide:
        ws = (words, w4) + ((w8, w12) + wide if lcp > 12 else ())
        rawA, rawB, rawC = sorted_matchfind_triple(h, ws, sort_seg, depth)
    else:
        rawA, rawB, rawC = pk.segment_probe(h, bp, sort_seg, depth,
                                            16 if lcp > 12 else 8, "lean")
    if use_content:
        rawD, rawE = content_sorted_matchfind(
            h, words, w4, w8, w12, sort_seg, max(depth * 2 // 3, 4), wide,
            content_doublings, content_round_probes)
        ext = ck.chain_extend_multi([rawA, rawB, rawC, rawD, rawE])
    elif ext_c:
        ext = ck.chain_extend_multi([rawA, rawB, rawC], strides2, strides1)
    else:
        # C (nearest occurrence) stays at its raw word-granular LCP
        ext = ck.chain_extend_multi([rawA, rawB], strides2, strides1)
        mC0, dC0, fC0 = rawC
        ext.append((torch.clamp(mC0 + torch.where(mC0 >= 4, fC0, 0),
                                max=MAX_LEN), dC0))

    zero = torch.zeros_like(words)
    lenA, dA, lenB, dB, lenC, dC = (zero,) * 6
    for ln, dd in ext:
        valid = (dd > 0) & (ln >= 4)
        ln = torch.where(valid, ln, 0)
        beats_a = (ln > lenA) | ((ln == lenA) & valid & (dd < dA))
        demote = beats_a & (dd != dA)
        newB_l = torch.where(demote, lenA, lenB)
        newB_d = torch.where(demote, dA, dB)
        beats_b = ~beats_a & valid & (dd != dA) & (ln > lenB)
        lenB = torch.where(beats_b, ln, newB_l)
        dB = torch.where(beats_b, dd, newB_d)
        lenA = torch.where(beats_a, ln, lenA)
        dA = torch.where(beats_a, dd, dA)
        beats_c = valid & ((dC == 0) | (dd < dC))
        lenC = torch.where(beats_c, ln, lenC)
        dC = torch.where(beats_c, dd, dC)
    if two_pass and sort_seg >= 2 * FSM_SEG:
        # the rescue candidate displaces A on a strictly longer match; the
        # displaced A becomes B unless the two share a distance
        mlen_c, dist_c = rescue_pass(h, bp, sort_seg, junk_val)
        beats_a = mlen_c > lenA
        demote = beats_a & (dist_c != dA)
        newB_l = torch.where(demote, lenA, lenB)
        newB_d = torch.where(demote, dA, dB)
        beats_b = ~beats_a & (mlen_c > lenB) & (dist_c != dA)
        lenB = torch.where(beats_b, mlen_c, newB_l)
        dB = torch.where(beats_b, dist_c, newB_d)
        lenA = torch.where(beats_a, mlen_c, lenA)
        dA = torch.where(beats_a, dist_c, dA)

    cap = torch.clamp(length - pos, 0, MAX_LEN)
    lenA, lenB, lenC = (torch.minimum(x, cap) for x in (lenA, lenB, lenC))
    d3 = torch.where(cap >= 3, hash3_dist(words, pos, length, sort_seg,
                                          junk_val), 0) if hash3 else zero
    return bp, pos, lenA, dA, lenB, dB, lenC, dC, d3


# the lean tiers' candidates: no content pass, 16-byte payloads, raw C,
# one relaxation round
LEAN_CANDIDATES = dict(use_content=False, use_wide=False, ext_c=False,
                       strides2=())


def parse_candidates_lean(b: torch.Tensor, length: torch.Tensor):
    """Lean-tier candidate generation: ``parse_candidates`` with
    ``LEAN_CANDIDATES`` (depth 6, no rescue pass, no hash3, 128 KiB
    windows)."""
    return parse_candidates(b, length, **LEAN_CANDIDATES)


def hash3_matchfind(h3, words, seg: int):
    """Nearest previous 3-byte match per position (``_hash3_matchfind``):
    one sort of every ``seg``-position segment by (3-byte hash, position),
    one neighbour, kept within distance 1024.  Returns dist [B, n], 0 for
    none.  It is the matchfind's first probe on the low three bytes of
    each word (its window check never binds under the 1024 cut)."""
    order, probe = sorted_segments(
        h3, (words & 0xFFFFFF, torch.zeros_like(words)), seg)
    dist = probe(1)[1]
    return unpermute(order, h3.shape, torch.where(dist <= 1024, dist, 0))[0]


def min_match_len(bp: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """[B, 1] adaptive minimum match length from the distinct bytes of a
    strided and a dense 4 KiB sample before ``length`` ([B, 1]), as
    ``_parse_chunk`` sets it: 9 for <= 5 distinct bytes, then 8, 7, 6, 5
    up to 7, 9, 15, 44, else MIN_MATCH."""
    B, n_pad = bp.shape
    stride = max(1, n_pad // 4096)
    seen = torch.zeros(B, 257, dtype=torch.int64, device=bp.device)
    for s, step in ((bp[:, ::stride][:, :4096], stride), (bp[:, :4096], 1)):
        live = torch.arange(s.shape[1], device=bp.device) * step < length
        seen.scatter_(1, torch.where(live, s.to(torch.int64), 256), 1)
    used = seen[:, :256].sum(1, keepdim=True)
    min_len = torch.full_like(used, MIN_MATCH)
    for most, ml in ((44, 5), (15, 6), (9, 7), (7, 8), (5, 9)):
        min_len = torch.where(used <= most, ml, min_len)
    return min_len


def greedy_candidates(b: torch.Tensor, length: torch.Tensor,
                      lazy: bool = False, two_pass: bool = False,
                      depth: int = 2, hash3: bool = False,
                      wide_ext: bool = False, wide_window: bool = False,
                      lcp: int = 16):
    """The matchfind half of ``_parse_chunk``, batched: b uint8 [B, n],
    length int [B].  Sorted matchfind over ``segment_sizes(n,
    wide_window)`` segments (``lcp`` 16 keeps the 16-byte payloads, 8 or
    12 the 8-byte ones); with ``two_pass`` a rescue pass over the row
    shifted by half a segment (depth 2, lcp 8) keeps its strictly longer
    matches; the cap at the chunk's end; the adaptive minimum length;
    with ``hash3`` len-3 matches where no longer one exists; with ``lazy``
    the offset-weighted one-position deferral.  Returns (bp, pos, span,
    is_match, dist, fsm_seg), arrays [B, n_pad] (pos [1, n_pad])."""
    (bp, pos, length, words, h, sort_seg, fsm_seg,
     junk_val) = _row_inputs(b, length, wide_window)
    if wide_ext:
        w4, w8, w12 = (ahead(words, k) for k in (4, 8, 12))
        mlen, dist = sorted_matchfind(h, words, w4, None if lcp <= 8 else w8,
                                      None if lcp <= 12 else w12, sort_seg,
                                      depth, True)
    else:
        mlen, dist = ck.chain_extend(*pk.segment_probe(
            h, bp, sort_seg, depth, 16 if lcp > 12 else 8))
    if two_pass and sort_seg >= 2 * FSM_SEG:
        mlen_b, dist_b = rescue_pass(h, bp, sort_seg, junk_val)
        better = mlen_b > mlen
        mlen = torch.where(better, mlen_b, mlen)
        dist = torch.where(better, dist_b, dist)

    cap = torch.clamp(length - pos, 0, MAX_LEN)
    mlen = torch.minimum(mlen, cap)
    min_len = min_match_len(bp, length)
    if hash3:
        d3 = hash3_dist(words, pos, length, sort_seg, junk_val)
        use3 = (mlen < MIN_MATCH) & (d3 > 0) & (cap >= 3) & (min_len <= 4)
        mlen = torch.where(use3, 3, mlen)
        dist = torch.where(use3, d3, dist)
        is_match = use3 | (mlen >= min_len)
    else:
        is_match = mlen >= min_len
    span = torch.where(is_match, mlen, 1)

    if lazy:
        # defer a match to a literal when the next position's match wins
        # 4*(next_len - cur_len) + bsr(cur_off) - bsr(next_off) > 2
        def nxt(x, fill):
            return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], 1)

        span_n, match_n, dist_n = (nxt(span, 1), nxt(is_match, False),
                                   nxt(dist, 1))
        score = 4 * (span_n - span) + bsr(dist) - bsr(dist_n)
        defer = is_match & match_n & (span_n >= span) & (score > 2)
        is_match = is_match & ~defer
        span = torch.where(is_match, span, 1)
    return bp, pos, span, is_match, dist, fsm_seg


def commit_items(span, is_match, dist, pos, length, seg: int):
    """Commit with same-distance merging over ``seg``-position segments,
    items past ``length`` ([B]) dropped: (commit_match, commit_lit, eff)
    as ``_parse_chunk`` and ``tpu_optimal._commit`` form them.  The FSM
    is ``scan_kernels.commit_fsm``: its kernel on CUDA, the plain
    ``scan_kernels.greedy_commit_merge`` on the CPU."""
    committed, eff = scan_kernels.commit_fsm(span, is_match, dist, seg)
    live = pos < length[:, None]
    return (committed & (eff >= 3) & live, committed & (eff < 3) & live,
            eff)


def parse_chunk(b: torch.Tensor, length: torch.Tensor, **options):
    """``_parse_chunk``, batched: ``greedy_candidates`` (same options),
    then ``commit_items``.  Returns (bp, pos, commit_match, commit_lit,
    eff, dist)."""
    bp, pos, span, is_match, dist, fsm_seg = greedy_candidates(
        b, length, **options)
    return (bp, pos, *commit_items(span, is_match, dist, pos, length,
                                   fsm_seg), dist)


def exclusive_bit_offsets(nb: torch.Tensor):
    """Exclusive prefix sum of bit counts along the last axis, and the
    total (``_exclusive_bit_offsets``)."""
    cs = torch.cumsum(nb.to(torch.int64), dim=-1)
    return cs - nb, cs[..., -1]


def group_premerge(values, nbits, offs, capw: int, group: int = GROUP):
    """Merge ``group``-position runs of [B, n] (value, nbits) items into
    (capw+1)-word buffers shifted to the group's in-word bit offset
    (``_group_premerge``).  Returns (sbuf [B, m, capw+1], gw [B, m]).  A
    group that does not divide n raises TypeError, as the reference's
    reshape does."""
    B, n = values.shape
    if n % group:
        raise TypeError(f"group_premerge: the group ({group}) must divide "
                         f"the stream ({n} items)")
    m = n // group
    v = values.reshape(B, m, group)
    nb = nbits.to(torch.int64).reshape(B, m, group)
    o = offs.to(torch.int64).reshape(B, m, group)
    goff = o[..., :1]
    loff = o - goff
    vm = v & ((1 << nb) - 1)
    sb = loff & 31
    lo = (vm << sb) & M32
    hi = torch.where(sb > 0, vm >> (32 - sb), 0)
    wsel = loff >> 5
    # disjoint bit positions within a group: a scatter-add is an OR; the
    # extra column catches words past capw, which the JAX one-hot drops
    buf = torch.zeros(B, m, capw + 1, dtype=torch.int64, device=v.device)
    buf.scatter_add_(2, torch.clamp(wsel, max=capw), lo)
    buf.scatter_add_(2, torch.clamp(wsel + 1, max=capw), hi)
    buf = buf[..., :capw]
    gs = goff & 31
    gw = goff[..., 0] >> 5
    bufp = torch.cat([torch.zeros_like(buf[..., :1]), buf], dim=-1)
    slo = torch.cat([(buf << gs) & M32, torch.zeros_like(buf[..., :1])], -1)
    shi = torch.where(gs > 0, bufp >> (32 - gs), 0)
    return slo | shi, gw


def add_bits(words: torch.Tensor, vals: torch.Tensor,
             offs: torch.Tensor) -> torch.Tensor:
    """[B, nwords] int64 words plus [B, k] items of < 32 bits at bit
    offsets ``offs``; an item's part in a word past the end is dropped
    (``.at[].add(mode="drop")``).  Returns the words 32-bit masked."""
    sb = offs & 31
    idx = torch.cat([offs >> 5, (offs >> 5) + 1], 1)
    add = torch.cat([(vals << sb) & M32,
                     torch.where(sb > 0, vals >> (32 - sb), 0)], 1)
    keep = idx < words.shape[1]
    return words.scatter_add(1, torch.where(keep, idx, 0),
                             torch.where(keep, add, 0)) & M32


def static_litlen_code(sym: torch.Tensor):
    """(bit-reversed codeword, nbits) of the RFC 1951 static litlen code
    (``_static_litlen_code``)."""
    sym = sym.to(torch.int64)
    val = torch.where(sym < 144, 0x30 + sym, torch.where(
        sym < 256, 0x190 + sym - 144,
        torch.where(sym < 280, sym - 256, 0xC0 + sym - 280)))
    bits = torch.where(sym < 144, 8, torch.where(
        sym < 256, 9, torch.where(sym < 280, 7, 8)))
    return rev(val, bits), bits


def static_items(bp, commit_match, commit_lit, eff, dist):
    """One (value, nbits) item per position of a static block
    (``compress_chunk_static``'s emission column): a literal's code, or a
    match's litlen code, length extra, 5-bit offset code and offset extra
    in one item of <= 31 bits."""
    lit_code, lit_bits = static_litlen_code(bp)
    lslot, lbase, lextra = length_slot(torch.clamp(eff, min=3))
    lsym_code, lsym_bits = static_litlen_code(257 + lslot)
    oslot, obase, oextra = offset_slot(torch.clamp(dist, min=1))
    sh2 = lsym_bits + lextra
    sh3 = sh2 + 5
    match_val = (lsym_code | ((eff - lbase) << lsym_bits)
                 | (rev16(oslot) >> 11) << sh2 | (dist - obase) << sh3)
    val = torch.where(commit_match, match_val & M32,
                      torch.where(commit_lit, lit_code, 0))
    nb = torch.where(commit_match, sh3 + oextra,
                     torch.where(commit_lit, lit_bits, 0))
    return val, nb


def static_nwords(n: int) -> int:
    """Word count of one static chunk's output: 9 bits a position and
    128 bits of header and tail."""
    return (9 * n + 128 + 31) // 32


def compress_chunks_static(bufs, lengths, bfinal, device=None,
                           on_stage: Callable[[str], None] | None = None):
    """Static-Huffman tier (``compress_chunks_static``): greedy parse at
    depth 2 over 64 KiB segments, one static block per chunk plus an
    empty stored block carrying BFINAL.  uint8[B, N], int[B], bool[B] ->
    (words int32[B, W] holding the uint32 bit patterns, total_bits
    int64[B]).  Runs on CUDA unless ``device`` names another device; the
    bits are placed by the pack kernel on CUDA, by ``kernels.group_place``
    on the CPU.  ``on_stage(name)`` marks each stage's start and the end;
    with a profiler session on, each stage is the range
    ``stage.<name>``."""
    with stage_marks(on_stage) as mark:
        bufs, lengths, bfinal = from_numpy_batch(bufs, lengths, bfinal,
                                                 device)
        n = bufs.shape[1]
        mark("candidates")
        bp, pos, span, is_match, dist, fsm_seg = greedy_candidates(bufs,
                                                                    lengths)
        mark("commit")
        cm, cl, eff = commit_items(span, is_match, dist, pos, lengths,
                                   fsm_seg)
        mark("emit_pre")
        val, nb = static_items(bp, cm, cl, eff, dist)
        offs, body_bits = exclusive_bit_offsets(nb)
        mark("premerge")
        sbuf, gw = group_premerge(val, nb, offs + 3, capw=GROUP_CAPW)
        mark("pack")
        words = kernels.pack_groups(sbuf, gw, static_nwords(n))
        mark("post")
        # block header (BFINAL 0, BTYPE 01), the 7-bit EOB, then the stored
        # sync-flush block: its 3-bit header, byte padding, LEN 0 and NLEN
        end = body_bits + 3
        pad = (-(end + 10)) % 8
        zero = torch.zeros_like(end)
        vals = torch.stack([zero + 0b010, zero, bfinal.to(torch.int64),
                            zero + 0xFFFF0000], 1)
        words = add_bits(words, vals,
                         torch.stack([zero, end, end + 7, end + 10 + pad], 1))
        mark("end")
        return to_i32(words), end + 10 + pad + 32


def device_stream_to_bytes(words, total_bits: int) -> bytes:
    """Host: one chunk's device bitstream as bytes.  ``words`` may be a
    tensor of int32/int64 words or a numpy array."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu()
        if words.dtype == torch.int64:
            words = words & M32
        words = words.numpy()
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words).astype("<u4").tobytes()[:nbytes]
