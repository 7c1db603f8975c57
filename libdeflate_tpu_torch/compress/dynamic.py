"""Dynamic-Huffman blocks and the dynamic compress tiers, on batched
tensors.

Counterpart of ``libdeflate_tpu/compress/tpu_dynamic.py``: the constants
(lines 62-74), ``_rev_bits_np``,
``_static_packed_tables`` and ``_header_consts`` (81-130),
``_build_code_lens_pair`` (264-275, with the refinement passes and
15-bit codes), ``_canonical_table`` (277), the
histogram ``_hist_matmul`` (303) and table translate ``_tree_translate``
(325), ``compress_chunk_dynamic`` and ``emit_dynamic_block`` (362-401),
``_p19_fixed`` (403), ``_precode_rle_items`` and ``_precode_rle_header``
(427-533), ``_fixed_hdr_items`` and the static header items (534-549),
the multi-block emission ``_emit_dynamic_pre_blocks`` (552-686),
``_dyn_nwords`` (688), ``_emit_dynamic_pre`` (696), ``_emit_dynamic_post``
(814) and the entries ``compress_chunks_dynamic{,2,3}`` (843-874) with
their ``_pallas`` twins (880-932; ``_compress_chunks_dynamic_pallas`` as
``compress_chunks_dynamic_with``), which compute the same bits: in the
port both are one path whose bit placement is the pack kernel on CUDA.

The one-hot matmul histogram becomes ``torch.bincount``, the select-tree
translate becomes indexing, and the duplicate-index ``.at[].add`` header
and tail scatters become ``scatter_add`` on int64 followed by a 32-bit
mask.  The sequential scans of the code-length build are a CUDA kernel
on the card (``scan_kernels.code_lens``, ``csrc/code_lens.cu``); their
plain version is ``scan_kernels.build_code_lens``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import constant, from_numpy_batch
from ..utils.profiling import stage_marks
from . import kernels, scan_kernels
from .bits import GROUP, M32, behind, length_slot, offset_slot, rev16, to_i32
from .pipeline import (
    add_bits,
    commit_items,
    exclusive_bit_offsets,
    greedy_candidates,
    group_premerge,
)
from .scan_kernels import MAX_CODE_LEN

NSYM = 286
NDIST = 30
NSYM_ALL = NSYM + NDIST
DONT_CARE = NSYM_ALL
MAX_CODE_LEN_DEEP = 15
DYN_CAPW = (128 * MAX_CODE_LEN + 31) // 32 + 1        # 45
DYN_CAPW_DEEP = (128 * MAX_CODE_LEN_DEEP + 31) // 32 + 1   # 61
# multi-block emission: the worst premerge group is 128 RLE header items
# of <= 14 bits
BLOCKS_CAPW = 58


def _rev_bits_np(x: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(16):
        out = (out << 1) | ((x >> i) & 1)
    return out >> (16 - nbits)


def _static_packed_tables() -> np.ndarray:
    """T[sym] = rev_code<<4 | len for the RFC 1951 static litlen code,
    followed by the 30 static 5-bit distance codes."""
    sym = np.arange(288)
    lens = np.where(sym < 144, 8,
                    np.where(sym < 256, 9, np.where(sym < 280, 7, 8)))
    code = np.where(
        sym < 144, 0x30 + sym,
        np.where(sym < 256, 0x190 + sym - 144,
                 np.where(sym < 280, sym - 256, 0xC0 + sym - 280)))
    rev = _rev_bits_np(code.astype(np.uint32), lens.astype(np.uint32))
    lit = ((rev << 4) | lens)[:NSYM]
    dsym = np.arange(NDIST).astype(np.uint32)
    drev = _rev_bits_np(dsym, np.full(NDIST, 5, np.uint32))
    return np.concatenate([lit, (drev << 4) | 5]).astype(np.int32)


T_STATIC_ALL = _static_packed_tables()                 # [316]
STATIC_LIT_LENS = T_STATIC_ALL[:NSYM] & 15

_PRECODE_PERM = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14,
                 1, 15]
HDR_BITS = 17 + 19 * 3 + NSYM * 4 + NDIST * 4          # 1338


def _header_consts():
    vals = [0b100, NSYM - 257, NDIST - 1, 15]
    bits = [3, 5, 5, 4]
    for p in _PRECODE_PERM:
        vals.append(0 if p >= 16 else 4)
        bits.append(3)
    offs = np.concatenate([[0], np.cumsum(bits)[:-1]]).astype(np.int32)
    return np.array(vals, np.uint32), offs, sum(bits)


HDR_VALS, HDR_OFFS, LENS_OFF = _header_consts()


def _p19_fixed():
    """Fixed complete precode: (lens[19], packed rev<<4|len table, lens
    in HCLEN order)."""
    lens = np.full(19, 5, np.int64)
    for s in (0, 16, 17, 18, 5, 6, 7, 8, 9, 10, 11, 12, 13):
        lens[s] = 4
    bl = np.bincount(lens, minlength=7)
    nxt = np.zeros(7, np.int64)
    for ln in range(1, 6):
        nxt[ln + 1] = (nxt[ln] + bl[ln]) << 1
    code = np.zeros(19, np.int64)
    cur = nxt.copy()
    for s in sorted(range(19), key=lambda s: (lens[s], s)):
        code[s] = cur[lens[s]]
        cur[lens[s]] += 1
    rev = _rev_bits_np(code.astype(np.uint32), lens.astype(np.uint32))
    tab = (rev.astype(np.int32) << 4) | lens.astype(np.int32)
    return lens, tab, lens[np.array(_PRECODE_PERM)]


P19_LENS, P19_TAB, P19_LENS_PERM = _p19_fixed()


def _const(x, dev) -> torch.Tensor:
    return constant(x, np.int64, dev)


def dyn_nwords(n: int, blocks: int = 1) -> int:
    """Word count of one chunk's output buffer (``_dyn_nwords``): 9 bits
    a position, and a fixed-size header and an EOB a block."""
    return (9 * n + (1 + blocks) * HDR_BITS + 256 + blocks * 16 + 31) // 32


def batched_hist(sym: torch.Tensor, nclasses: int) -> torch.Tensor:
    """Per-row histogram of [B, n] symbols over classes 0..nclasses-1;
    symbols >= nclasses are not counted (``_hist_matmul``)."""
    B = sym.shape[0]
    idx = torch.clamp(sym.to(torch.int64), max=nclasses)
    idx = idx + (nclasses + 1) * torch.arange(B, device=sym.device)[:, None]
    h = torch.bincount(idx.reshape(-1), minlength=B * (nclasses + 1))
    return h.reshape(B, nclasses + 1)[:, :nclasses]


def build_code_lens_pair(hist_lit: torch.Tensor, hist_dist: torch.Tensor,
                         refine_passes: int = 0,
                         max_len: int = MAX_CODE_LEN):
    """Both alphabets in one batched build (``_build_code_lens_pair``):
    the distance histogram is zero-padded to 286 symbols.  The build is
    ``scan_kernels.code_lens``: its kernel on CUDA, the plain
    ``scan_kernels.build_code_lens`` on the CPU."""
    B = hist_lit.shape[0]
    h = torch.stack([hist_lit, torch.nn.functional.pad(
        hist_dist, (0, NSYM - NDIST))], 1).reshape(2 * B, NSYM)
    lens, ok = scan_kernels.code_lens(h, refine_passes, max_len)
    lens, ok = lens.reshape(B, 2, NSYM), ok.reshape(B, 2)
    return lens[:, 0], lens[:, 1, :NDIST], ok[:, 0], ok[:, 1]


# RFC 1951 3.2.2's loop ``code = (code + bl_count[ln - 1]) << 1`` unrolled:
# the first code of length ln is the sum over j < ln of bl_count[j] << (ln - j)
_FIRST_CODE_WEIGHTS = np.array(
    [[1 << (ln - j) if j < ln else 0 for ln in range(MAX_CODE_LEN_DEEP + 1)]
     for j in range(MAX_CODE_LEN_DEEP + 1)], np.int64)


def canonical_table(lens: torch.Tensor) -> torch.Tensor:
    """T[sym] = rev_code<<4 | len per row, canonical per RFC 1951 3.2.2
    (``_canonical_table``).  The first code of each length comes from one
    product with ``_FIRST_CODE_WEIGHTS``, not a loop of 15 small steps."""
    lens = lens.to(torch.int64)
    l_iota = torch.arange(MAX_CODE_LEN_DEEP + 1, device=lens.device)
    onehot = (lens[..., None] == l_iota).to(torch.int64)   # [R, nsym, 16]
    bl_count = onehot.sum(1)
    bl_count[:, 0] = 0
    first = (bl_count[..., None] * _const(_FIRST_CODE_WEIGHTS,
                                          lens.device)).sum(-2)
    # rank among same-length symbols of lower index
    rank = (torch.cumsum(onehot, 1) - onehot).gather(2, lens[..., None])[..., 0]
    code = first.gather(1, lens) + rank
    rv = rev16(code) >> (16 - torch.clamp(lens, min=1))
    return torch.where(lens > 0, (rv << 4) | lens, 0)


def precode_rle_items(all_lens: torch.Tensor):
    """RLE'd dynamic header items for [B, 316] code lengths, HLIT and
    HDIST 29 (``_precode_rle_items``).  Returns (vals [B, 339], bits [B, 339],
    total [B])."""
    B, n = all_lens.shape
    dev = all_lens.device
    v = all_lens.to(torch.int64)
    i = torch.arange(n, device=dev)
    start = v != behind(v, -1)
    run_start = torch.cummax(torch.where(start, i, 0), 1).values
    endpos = v != torch.cat([v[:, 1:], torch.full_like(v[:, :1], -2)], 1)
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(endpos, i, n - 1), [1]), 1).values, [1]) + 1
    L = run_end - run_start
    k = i - run_start

    is0 = v == 0
    # zero runs: full 138-chunks then an 18/17/raw tail
    t0 = (L // 138) * 138
    r0 = L - t0
    z_full = (k % 138 == 0) & (k < t0)
    z18t = (k == t0) & (r0 >= 11)
    z17t = (k == t0) & (r0 >= 3) & (r0 < 11)
    z_raw = (k >= t0) & (r0 < 3)
    # nonzero runs: raw value first, then 6-repeat chunks, 16/raw tail
    rel = k - 1
    t0r = ((L - 1) // 6) * 6
    rr = L - 1 - t0r
    nz_first = k == 0
    nz_full = (k >= 1) & (rel % 6 == 0) & (rel < t0r)
    nz16t = (k >= 1) & (rel == t0r) & (rr >= 3)
    nz_raw = (k >= 1) & (rel >= t0r) & (rr < 3)

    emit = torch.where(is0, z_full | z18t | z17t | z_raw,
                       nz_first | nz_full | nz16t | nz_raw)
    sym = torch.where(
        is0, torch.where(z_full | z18t, 18, torch.where(z17t, 17, 0)),
        torch.where(nz_first | nz_raw, v, 16))
    extra = torch.where(
        is0,
        torch.where(z_full, 127,
                    torch.where(z18t, r0 - 11, torch.where(z17t, r0 - 3, 0))),
        torch.where(nz_full, 3, torch.where(nz16t, rr - 3, 0)))
    ebits = torch.where(sym == 18, 7, torch.where(
        sym == 17, 3, torch.where(sym == 16, 2, 0)))
    ebits = torch.where(emit, ebits, 0)

    entry = _const(P19_TAB, dev)[torch.clamp(sym, 0, 18)]
    clen = torch.where(emit, entry & 15, 0)
    item_vals = torch.where(emit, (entry >> 4) | (extra << clen), 0)
    item_bits = clen + ebits

    f_vals = _const([0b100, NSYM - 257, NDIST - 1, 19 - 4], dev).expand(B, 4)
    f_bits = _const([3, 5, 5, 4], dev).expand(B, 4)
    p_vals = _const(P19_LENS_PERM, dev).expand(B, 19)
    p_bits = torch.full((B, 19), 3, dtype=torch.int64, device=dev)
    vals = torch.cat([f_vals, p_vals, item_vals], 1)
    bits = torch.cat([f_bits, p_bits, item_bits], 1)
    return vals, bits, bits.sum(1)


def precode_rle_header(all_lens: torch.Tensor):
    """The RLE header items placed into words (``_precode_rle_header``).
    The buffer holds the longest possible header (339 items of <= 12
    bits) so no index falls outside it; callers use the first 44 words
    only when the header is shorter than the fixed layout."""
    vals, bits, total = precode_rle_items(all_lens)
    offs = torch.cumsum(bits, 1) - bits
    return add_bits(torch.zeros(vals.shape[0], 128, dtype=torch.int64,
                                device=vals.device), vals, offs), total


def fixed_hdr_items(all_lens: torch.Tensor):
    """The constant 1338-bit header layout as [R, 339] emission items
    (``_fixed_hdr_items``): the prelude and precode lengths, then each of
    the 316 code lengths bit-reversed in 4 bits.  Returns (vals, bits)."""
    R = all_lens.shape[0]
    dev = all_lens.device
    vals = torch.cat([_const(HDR_VALS, dev).expand(R, len(HDR_VALS)),
                      rev16(all_lens.to(torch.int64)) >> 12], 1)
    bits = _const([3, 5, 5, 4] + [3] * 19 + [4] * NSYM_ALL, dev)
    return vals, bits.expand(R, -1)


# a static block's header as 339 items: BTYPE 01 and nothing else
STATIC_HDR_ITEM_VALS = np.zeros(339, np.int64)
STATIC_HDR_ITEM_VALS[0] = 0b010
STATIC_HDR_ITEM_BITS = np.zeros(339, np.int64)
STATIC_HDR_ITEM_BITS[0] = 3


def item_sym(bp, commit_match, commit_lit, oslot, lslot):
    """The combined alphabet a position emits: its literal byte, 257 +
    the length slot at a match start, 286 + the offset slot one position
    after it, else DONT_CARE."""
    return torch.where(
        commit_match, 257 + lslot,
        torch.where(behind(commit_match, False), NSYM + behind(oslot),
                    torch.where(commit_lit, bp.to(torch.int64), DONT_CARE)))


def body_columns(code_at, commit_match, commit_lit, eff, dist, lbase,
                 lextra, obase, oextra):
    """(val, nb) a position emits from its code-table entry ``code_at``
    (rev<<4 | len): slot A (a literal, or a match start's length code and
    extra bits) or slot B (the position after a match start: the offset
    code and extra bits)."""
    clen = code_at & 15
    ccode = code_at >> 4
    lx = torch.where(commit_match, eff - lbase, 0)
    val_a = ccode | (lx << clen)
    nb_a = torch.where(commit_match, clen + lextra,
                       torch.where(commit_lit, clen, 0))
    ox_b = behind((dist - obase) & M32)
    val_b = ccode | (ox_b << clen)
    nb_b = clen + behind(oextra)
    prev_match = behind(commit_match, False)
    val = torch.where(prev_match, val_b,
                      torch.where(commit_match | commit_lit, val_a, 0)) & M32
    return val, torch.where(prev_match, nb_b, nb_a)


def code_hists(sym: torch.Tensor):
    """Litlen [R, 286] and offset [R, 30] histograms of [R, n] symbols,
    EOB counted once and symbols 0 (litlen) and 0, 1 (offset) forced to
    1 where unused."""
    hist = batched_hist(sym, NSYM_ALL)
    hist_lit = hist[:, :NSYM].clone()
    hist_lit[:, 256] += 1                                      # EOB
    hist_lit[:, 0] += (hist_lit[:, 0] == 0).to(torch.int64)
    hist_dist = hist[:, NSYM:].clone()
    hist_dist[:, 0] += (hist_dist[:, 0] == 0).to(torch.int64)
    hist_dist[:, 1] += (hist_dist[:, 1] == 0).to(torch.int64)
    return hist_lit, hist_dist


def emit_dynamic_pre_blocks(bp, commit_match, commit_lit, eff, dist,
                            blocks: int, refine_passes: int = 0):
    """Multi-block emission (``_emit_dynamic_pre_blocks``): each chunk of
    [B, n_pad] commit arrays as ``blocks`` DEFLATE blocks of n_pad /
    blocks positions with a code of their own, over the chunk's one LZ
    window.  Per-block histograms, one code-length build over 2 * blocks
    rows a chunk, per-block canonical tables, the RLE, fixed or static
    header, and one entry stream ``[header 339][body][EOB 1]`` a block,
    zero-padded to a multiple of 128 entries only.  Returns ((val, nb,
    offs), aux) with aux shaped for ``emit_dynamic_post`` (no header
    words, the EOBs in the stream).  n_pad must be a multiple of blocks *
    128, and each block of 1024 positions (a DP segment), as the
    reference asserts."""
    B, n_pad = bp.shape
    dev = bp.device
    nb_blk = n_pad // blocks
    if n_pad % (blocks * 128) or nb_blk % 1024:
        raise AssertionError(f"emit_dynamic_pre_blocks: {n_pad} positions "
                             f"do not split into {blocks} blocks of a "
                             f"multiple of 1024")
    eff = eff.to(torch.int64)
    dist = dist.to(torch.int64)
    lslot, lbase, lextra = length_slot(torch.clamp(eff, min=3))
    oslot, obase, oextra = offset_slot(torch.clamp(dist, min=1))
    sym = item_sym(bp, commit_match, commit_lit, oslot, lslot)

    # per-block code tables: rows (chunk, block)
    R = B * blocks
    hist_lit, hist_dist = code_hists(sym.reshape(R, nb_blk))
    max_len = MAX_CODE_LEN_DEEP if refine_passes else MAX_CODE_LEN
    lit_lens, dist_lens, ok_l, ok_d = build_code_lens_pair(
        hist_lit, hist_dist, refine_passes, max_len)
    t_lit = canonical_table(lit_lens)
    t_dist = canonical_table(dist_lens)
    all_lens = torch.cat([lit_lens, dist_lens], 1)           # [R, 316]
    rle_v, rle_b, rle_tot = precode_rle_items(all_lens)
    fix_v, fix_b = fixed_hdr_items(all_lens)
    use_rle = rle_tot < HDR_BITS
    hdr_dyn_bits = torch.where(use_rle, rle_tot, HDR_BITS)
    dyn_cost = ((hist_lit * lit_lens).sum(1) + (hist_dist * dist_lens).sum(1)
                + hdr_dyn_bits)
    static_cost = ((hist_lit * _const(STATIC_LIT_LENS, dev)).sum(1)
                   + 5 * hist_dist.sum(1) + 3)
    use_dyn = (ok_l & ok_d & (dyn_cost < static_cost))[:, None]
    table = torch.where(use_dyn, torch.cat([t_lit, t_dist], 1),
                        _const(T_STATIC_ALL, dev))
    hv = torch.where(use_dyn, torch.where(use_rle[:, None], rle_v, fix_v),
                     _const(STATIC_HDR_ITEM_VALS, dev))
    hb = torch.where(use_dyn, torch.where(use_rle[:, None], rle_b, fix_b),
                     _const(STATIC_HDR_ITEM_BITS, dev))

    # body columns through each block's table
    code_at = torch.cat([table, torch.zeros_like(table[:, :1])], 1).gather(
        1, sym.reshape(R, nb_blk)).reshape(B, n_pad)
    val, nb = body_columns(code_at, commit_match, commit_lit, eff, dist,
                           lbase, lextra, obase, oextra)

    # one entry stream: [header 339][body nb_blk][EOB 1] a block
    tbl_eob = table[:, 256:257]
    vals = torch.cat([hv, val.reshape(R, nb_blk), tbl_eob >> 4], 1)
    nbits = torch.cat([hb, nb.reshape(R, nb_blk), tbl_eob & 15], 1)
    ent = blocks * (339 + nb_blk + 1)
    pad = (-ent) % 128
    vals = torch.nn.functional.pad(vals.reshape(B, ent), (0, pad))
    nbits = torch.nn.functional.pad(nbits.reshape(B, ent), (0, pad))
    offs, total_bits = exclusive_bit_offsets(nbits)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    aux = (torch.zeros(B, 44, dtype=torch.int64, device=dev), zero, zero,
           zero, total_bits)
    return (vals, nbits, offs), aux


def emit_dynamic_pre(bp, commit_match, commit_lit, eff, dist,
                     refine_passes: int = 0):
    """Symbol translation, code tables, emission columns, bit offsets and
    the 44 header words for [B, n_pad] commit arrays
    (``_emit_dynamic_pre``): 11-bit codes at refine 0, else 15-bit codes
    and ``refine_passes`` refinement passes.  Returns ((val, nb, offs),
    aux)."""
    B = bp.shape[0]
    dev = bp.device
    eff = eff.to(torch.int64)
    dist = dist.to(torch.int64)
    lslot, lbase, lextra = length_slot(torch.clamp(eff, min=3))
    oslot, obase, oextra = offset_slot(torch.clamp(dist, min=1))
    sym = item_sym(bp, commit_match, commit_lit, oslot, lslot)
    hist_lit, hist_dist = code_hists(sym)

    max_len = MAX_CODE_LEN_DEEP if refine_passes else MAX_CODE_LEN
    lit_lens, dist_lens, ok_l, ok_d = build_code_lens_pair(
        hist_lit, hist_dist, refine_passes, max_len)
    t_lit = canonical_table(lit_lens)
    t_dist = canonical_table(dist_lens)
    all_lens = torch.cat([lit_lens, dist_lens], 1)
    rle_words, rle_bits = precode_rle_header(all_lens)
    use_rle = rle_bits < HDR_BITS
    hdr_dyn_bits = torch.where(use_rle, rle_bits, HDR_BITS)

    # block-type choice on symbol-level cost (extra bits are identical)
    dyn_cost = ((hist_lit * lit_lens).sum(1) + (hist_dist * dist_lens).sum(1)
                + hdr_dyn_bits)
    static_cost = ((hist_lit * _const(STATIC_LIT_LENS, dev)).sum(1)
                   + 5 * hist_dist.sum(1) + 3)
    use_dyn = ok_l & ok_d & (dyn_cost < static_cost)
    table = torch.where(use_dyn[:, None], torch.cat([t_lit, t_dist], 1),
                        _const(T_STATIC_ALL, dev))
    # DONT_CARE positions (sym == 316) read a zero entry and emit nothing
    code_at = torch.cat([table, torch.zeros_like(table[:, :1])], 1).gather(
        1, sym)
    val, nb = body_columns(code_at, commit_match, commit_lit, eff, dist,
                           lbase, lextra, obase, oextra)

    hdr_bits_n = torch.where(use_dyn, hdr_dyn_bits, 3)
    offs, body_bits = exclusive_bit_offsets(nb)
    offs = offs + hdr_bits_n[:, None]

    # header words: dynamic (RLE or the constant layout) or static
    hvals = torch.cat([_const(HDR_VALS, dev).expand(B, len(HDR_VALS)),
                       rev16(all_lens) >> 12], 1)
    hoffs = torch.cat([_const(HDR_OFFS, dev),
                       LENS_OFF + 4 * torch.arange(NSYM_ALL, device=dev)])
    hdr_words = add_bits(torch.zeros(B, 44, dtype=torch.int64, device=dev),
                         hvals, hoffs.expand(B, -1))
    hdr_words = torch.where(use_rle[:, None], rle_words[:, :44], hdr_words)
    static_hdr = torch.zeros(44, dtype=torch.int64, device=dev)
    static_hdr[0] = 0b010
    hdr44 = torch.where(use_dyn[:, None], hdr_words, static_hdr)

    tbl_eob = table[:, 256]
    aux = (hdr44, tbl_eob >> 4, tbl_eob & 15, hdr_bits_n, body_bits)
    return (val, nb, offs), aux


def emit_dynamic_post(words: torch.Tensor, aux, bfinal: torch.Tensor):
    """Add the header words and the EOB / byte-align / sync-flush tail to
    packed [B, nwords] int64 words (``_emit_dynamic_post``); tail words
    past the end are dropped.  Returns (words int64, total_bits)."""
    hdr44, eob_code, eob_len, hdr_bits_n, body_bits = aux
    words = torch.cat([words[:, :44] + hdr44, words[:, 44:]], 1)
    eob_off = body_bits + hdr_bits_n
    end = eob_off + eob_len
    pad_bits = (-(end + 3)) % 8
    vals = torch.stack([eob_code, bfinal.to(torch.int64),
                        torch.full_like(eob_code, 0xFFFF0000)], 1)
    words = add_bits(words, vals,
                     torch.stack([eob_off, end, end + 3 + pad_bits], 1))
    return words, end + 3 + pad_bits + 32


def emit_dynamic_block(bp, bfinal, commit_match, commit_lit, eff, dist,
                       n: int, refine_passes: int = 0,
                       mark: Callable[[str], None] = lambda name: None,
                       blocks: int = 1, group: int = GROUP):
    """Entropy-code and pack committed items into one byte-aligned
    fragment a chunk (``emit_dynamic_block``, and the back end of
    ``_compress_chunks_optimal_pallas``): ``emit_dynamic_pre`` (or
    ``emit_dynamic_pre_blocks`` for ``blocks`` > 1), the premerge of
    ``group``-item groups (their rows scaled from 128 items' width), the
    pack kernel (``kernels.group_place`` on the CPU) and
    ``emit_dynamic_post``, with a ``mark`` at each stage.  Returns (words
    int32 [B, W], total_bits int64 [B])."""
    mark("emit_pre")
    capw = DYN_CAPW_DEEP if refine_passes else DYN_CAPW
    if blocks > 1:
        (val, nb, offs), aux = emit_dynamic_pre_blocks(
            bp, commit_match, commit_lit, eff, dist, blocks, refine_passes)
        capw = max(capw, BLOCKS_CAPW)
    else:
        (val, nb, offs), aux = emit_dynamic_pre(
            bp, commit_match, commit_lit, eff, dist, refine_passes)
    mark("premerge")
    sbuf, gw = group_premerge(val, nb, offs, (capw - 1) * group // GROUP + 1,
                              group)
    mark("pack")
    words = kernels.pack_groups(sbuf, gw, dyn_nwords(n, blocks))
    mark("post")
    words, total_bits = emit_dynamic_post(words, aux, bfinal)
    return to_i32(words), total_bits


# the keywords of ``compress_chunks_dynamic_with`` that each dynamic tier
# sets, as compress_chunk_dynamic{,2,3} do
TIERS = {
    "dyn1": {},
    "dyn2": dict(two_pass=True),
    "dyn3": dict(two_pass=True, depth=12, hash3=True),
}


def greedy_options(two_pass: bool = False, depth: int = 6,
                   hash3: bool = False, lcp: int = 16):
    """(``greedy_candidates`` keywords, refinement passes) of
    ``_compress_chunks_dynamic_pallas``: a lazy parse, the rescue pass
    with ``two_pass``, 64 KiB segments and the A/B chain extension with
    ``two_pass`` or ``hash3`` (then 16 refinement passes and 15-bit
    codes), else 128 KiB segments and 11-bit codes."""
    quality = two_pass or hash3
    return (dict(lazy=True, two_pass=two_pass, depth=depth, hash3=hash3,
                 wide_ext=quality, wide_window=not quality, lcp=lcp),
            16 if quality else 0)


def compress_chunks_dynamic_with(
        bufs, lengths, bfinal, device=None,
        on_stage: Callable[[str], None] | None = None, *,
        two_pass: bool = False, depth: int = 6, hash3: bool = False,
        lcp: int = 16):
    """``_compress_chunks_dynamic_pallas`` with its keywords: the greedy
    parser's options (``greedy_options``; ``lcp`` 8 or 12 gives the
    matchfind 8-byte payloads), then one dynamic block a chunk.  The
    A/B chain extension follows ``two_pass or hash3`` here, as on that
    path.  Same contract as ``compress_chunks_dynamic``; with a profiler
    session on, each stage is the range ``stage.<name>``."""
    options, refine_passes = greedy_options(two_pass, depth, hash3, lcp)
    with stage_marks(on_stage) as mark:
        bufs, lengths, bfinal = from_numpy_batch(bufs, lengths, bfinal,
                                                 device)
        mark("candidates")
        bp, pos, span, is_match, dist, fsm_seg = greedy_candidates(
            bufs, lengths, **options)
        mark("commit")
        cm, cl, eff = commit_items(span, is_match, dist, pos, lengths,
                                   fsm_seg)
        out = emit_dynamic_block(bp, bfinal, cm, cl, eff, dist,
                                 bufs.shape[1], refine_passes, mark)
        mark("end")
        return out


def compress_chunks_dynamic(bufs, lengths, bfinal, device=None,
                            on_stage: Callable[[str], None] | None = None):
    """Single-pass dynamic tier, dyn1 (``compress_chunks_dynamic`` and,
    with the same bits, ``compress_chunks_dynamic_pallas``): depth-6 lazy
    parse over 128 KiB segments, 11-bit codes.  uint8[B, N], int[B],
    bool[B] -> (words int32[B, W] holding the uint32 bit patterns,
    total_bits int64[B]); each chunk one dynamic or static block plus an
    empty stored block carrying BFINAL.  Runs on CUDA unless ``device``
    names another device; ``on_stage(name)`` marks each stage's start
    and the end."""
    return compress_chunks_dynamic_with(bufs, lengths, bfinal, device,
                                        on_stage, **TIERS["dyn1"])


def compress_chunks_dynamic2(bufs, lengths, bfinal, device=None,
                             on_stage: Callable[[str], None] | None = None):
    """Two-pass dynamic tier, dyn2 (``compress_chunks_dynamic2`` and
    ``_dynamic2_pallas``): as ``compress_chunks_dynamic`` with the rescue
    pass, 64 KiB segments, the A/B chain extension, 16 refinement passes
    and 15-bit codes."""
    return compress_chunks_dynamic_with(bufs, lengths, bfinal, device,
                                        on_stage, **TIERS["dyn2"])


def compress_chunks_dynamic3(bufs, lengths, bfinal, device=None,
                             on_stage: Callable[[str], None] | None = None):
    """Deep-probe dynamic tier, dyn3 (``compress_chunks_dynamic3`` and
    ``_dynamic3_pallas``): as ``compress_chunks_dynamic2`` with depth 12
    and len-3 matches (``hash3_matchfind``)."""
    return compress_chunks_dynamic_with(bufs, lengths, bfinal, device,
                                        on_stage, **TIERS["dyn3"])
