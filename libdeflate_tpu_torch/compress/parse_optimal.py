"""Near-optimal parse (levels 10-12): match caching + min-cost path DP.

Role parity with ``deflate_compress_near_optimal``
(``lib/deflate_compress.c:3592-3849``): collect *all* matches per position,
run a backwards min-cost DP over the block, derive real Huffman codes from
the chosen path, and iterate cost refinement up to ``max_optim_passes``.

Level parameter parity (lib/deflate_compress.c:3981-4011):
    level 10: depth 35,  nice 75,  2 passes
    level 11: depth 100, nice 150, 4 passes
    level 12: depth 300, nice 258, 10 passes

The port's own copy of ``libdeflate_tpu/compress/parse_optimal.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import (
    END_OF_BLOCK,
    LENGTH_SLOT_EXTRA,
    LENGTH_TO_SLOT,
    OFFSET_SLOT_EXTRA,
    SOFT_MAX_BLOCK_LENGTH,
    COMPRESSOR_MAX_LITLEN_CODEWORD_LEN,
    offset_to_slot,
)
from ..huffman.build import package_merge_lengths
from . import parse_host
from .emit import BitWriter, flush_block

# Fractional-bit cost scale (reference BIT_COST=16, lib/deflate_compress.c:121-140)
BIT_COST = 16

OPT_PARAMS = {
    10: dict(depth=35, nice=75, passes=2),
    11: dict(depth=100, nice=150, passes=4),
    12: dict(depth=300, nice=258, passes=10),
}

_MAX_MATCHES_PER_POS = 32


class _BlockStats:
    """Online distribution-shift detector (should_end_block role,
    lib/deflate_compress.c:2141-2218): 8 literal classes + 2 match
    classes, checked every 512 observations at item cadence."""

    __slots__ = ("newo", "obs", "num_new", "num")

    def __init__(self):
        self.newo = [0] * 10
        self.obs = [0] * 10
        self.num_new = 0
        self.num = 0

    def literal(self, lit: int) -> None:
        self.newo[((lit >> 5) & 6) | (lit & 1)] += 1
        self.num_new += 1

    def match(self, length: int) -> None:
        self.newo[8 + (length >= 9)] += 1
        self.num_new += 1

    def should_end(self, block_len: int, remaining: int) -> bool:
        if self.num_new < 512 or block_len < 5000 or remaining < 5000:
            return False
        if self.num > 0:
            total_delta = 0
            for i in range(10):
                total_delta += abs(
                    self.newo[i] * self.num - self.obs[i] * self.num_new
                )
            num_items = self.num + self.num_new
            cutoff = (self.num_new * 200 // 512) * self.num
            if block_len < 10000 and num_items < 8192:
                cutoff += cutoff * (8192 - num_items) // 8192
            if total_delta + (block_len // 4096) * self.num >= cutoff:
                return True
        for i in range(10):
            self.obs[i] += self.newo[i]
            self.newo[i] = 0
        self.num += self.num_new
        self.num_new = 0
        return False


def _collect_matches(data: bytes, block_start: int, max_block_end: int,
                     depth: int, nice: int, state=None):
    """All useful matches per position, sorted by increasing length, with
    an online block-split check at item cadence (the reference observes
    the item stream during collection and ends the block at a detected
    statistics change point, lib/deflate_compress.c:3648-3776).

    Like bt_matchfinder_get_matches (lib/bt_matchfinder.h:296-315), only
    strictly-longer successive matches are kept (each with its nearest
    offset).  Hash chains stand in for the binary tree on the host path.
    ``state`` is an optional (h4, h3, mf) tuple carried across blocks so the
    whole-buffer hashes and the chain tables are built once per call, not
    once per 300 KB block.

    Returns (matches, block_end, state).
    """
    n = len(data)
    if state is None:
        h4, h3 = parse_host._hashes(data)
        mf = parse_host.HashChains(data)
        # Pre-insert history before the block (window context).
        for p in range(max(block_start - 32768, 0), block_start):
            if p < n - 3:
                mf.insert(p, h4, h3)
    else:
        h4, h3, mf = state

    stats = _BlockStats()
    matches: list[list[tuple[int, int]]] = [
        [] for _ in range(max_block_end - block_start)
    ]
    block_end = max_block_end
    next_observation = block_start
    i = block_start
    while i < block_end:
        limit = min(258, n - i)
        found: list[tuple[int, int]] = []
        if limit >= 3 and i < n - 3:
            best = 2
            j = int(mf.head3[h3[i]])
            if j >= 0 and i - j <= 32768:
                l = parse_host._lcp(data, i, j, limit)
                if l >= 3:
                    found.append((l, i - j))
                    best = l
            d = depth
            j = int(mf.head4[h4[i]])
            while j >= 0 and i - j <= 32768 and d > 0 and best < min(nice, limit):
                l = parse_host._lcp(data, i, j, limit)
                if l > best and l >= 4:
                    found.append((l, i - j))
                    best = l
                j = int(mf.prev4[j])
                d -= 1
            mf.insert(i, h4, h3)
        # `found` is in increasing length order: keep the longest ones
        matches[i - block_start] = found[-_MAX_MATCHES_PER_POS:]
        # item-cadence observation: a match suppresses observations for the
        # bytes it covers (observing every overlapping candidate splits
        # blocks ~5x too often)
        if i >= next_observation:
            if found and found[-1][0] >= 4:
                stats.match(found[-1][0])
                next_observation = i + found[-1][0]
            else:
                stats.literal(data[i])
                next_observation = i + 1
        # Like the reference, skip deep insertion inside very long matches.
        if found and found[-1][0] >= nice:
            skip_to = min(i + found[-1][0], block_end, n - 3)
            for p in range(i + 1, skip_to):
                mf.insert(p, h4, h3)
            for p in range(i + 1, skip_to):
                matches[p - block_start] = []
            i = skip_to
        else:
            i += 1
        if stats.should_end(i - block_start, n - i):
            block_end = i
            matches = matches[: block_end - block_start]
            break
    return matches, block_end, (h4, h3, mf)


def _default_costs():
    """NOSTAT default costs (reference: 13/13/10 bits scaled by BIT_COST)."""
    lit_cost = np.full(256, 13 * BIT_COST, dtype=np.int64)
    len_sym_cost = np.full(29, 13 * BIT_COST, dtype=np.int64)
    off_sym_cost = np.full(30, 10 * BIT_COST, dtype=np.int64)
    return lit_cost, len_sym_cost, off_sym_cost


# Blend weight for tempering measured literal entropy with the flat default
# (native MW_TEMPER; the reference's default-cost table is parameterized the
# same way by match probability, lib/deflate_compress.c:2986-3102)
_MW_TEMPER = 8


def _seeded_costs(data: bytes, block_start: int, block_end: int, prev_lens):
    """First-pass costs: block byte entropy tempered toward the flat
    default (matches consume literal occurrences, flattening the final
    distribution), then averaged with the previous block's real code
    lengths when available (the reference's previous-block cost mixing,
    lib/deflate_compress.c:3207-3296)."""
    blen = block_end - block_start
    bh = np.bincount(
        np.frombuffer(data[block_start:block_end], dtype=np.uint8),
        minlength=256,
    ).astype(np.float64)
    p = (bh + 0.5) / (blen + 128)
    ent = np.rint(-np.log2(p) * BIT_COST).astype(np.int64)
    ent = np.clip(ent, BIT_COST, 14 * BIT_COST)
    lit_cost = (ent * (16 - _MW_TEMPER) + 13 * BIT_COST * _MW_TEMPER) // 16
    len_sym_cost = np.full(29, 13 * BIT_COST, dtype=np.int64)
    off_sym_cost = np.full(30, 10 * BIT_COST, dtype=np.int64)
    if prev_lens is not None:
        prev_ll, prev_ofl = prev_lens
        ll = prev_ll.astype(np.int64)
        ol = prev_ofl.astype(np.int64)
        pc = np.where(ll[:256] > 0, ll[:256], 13) * BIT_COST
        lit_cost = (lit_cost + pc) // 2
        has_len = ll[257:286] > 0
        len_sym_cost = np.where(
            has_len, (ll[257:286] + 13) * BIT_COST // 2, len_sym_cost
        )
        has_off = ol[:30] > 0
        off_sym_cost = np.where(
            has_off, (ol[:30] + 10) * BIT_COST // 2, off_sym_cost
        )
    return lit_cost, len_sym_cost, off_sym_cost


def _costs_from_lens(litlen_lens, off_lens):
    """Codeword lens -> scaled costs; unused symbols get a high default."""
    ll = litlen_lens.astype(np.int64)
    ol = off_lens.astype(np.int64)
    lit_cost = np.where(ll[:256] > 0, ll[:256], 13) * BIT_COST
    len_sym_cost = np.where(ll[257:286] > 0, ll[257:286], 13) * BIT_COST
    off_sym_cost = np.where(ol[:30] > 0, ol[:30], 10) * BIT_COST
    return lit_cost, len_sym_cost, off_sym_cost


def _min_cost_path(data, block_start, block_end, matches, lit_cost, len_sym_cost, off_sym_cost):
    """Backwards DP (reference deflate_find_min_cost_path,
    lib/deflate_compress.c:3327-3399).  Returns per-position item choice."""
    blen = block_end - block_start
    cost = np.zeros(blen + 1, dtype=np.int64)
    choice_len = np.ones(blen + 1, dtype=np.int32)
    choice_off = np.zeros(blen + 1, dtype=np.int32)

    len_cost = (
        len_sym_cost[LENGTH_TO_SLOT[np.arange(259)]]
        + LENGTH_SLOT_EXTRA[LENGTH_TO_SLOT[np.arange(259)]] * BIT_COST
    )
    # Candidate lengths per match: slot-boundary lengths + the full length.
    # Within a slot the symbol cost is constant, so boundaries plus the
    # maximum capture (nearly) all DP-optimal choices at a fraction of the
    # 3..258 sweep.
    from ..formats.deflate import LENGTH_SLOT_BASE

    slot_bases = LENGTH_SLOT_BASE.astype(np.int64)

    for pos in range(blen - 1, -1, -1):
        abs_pos = block_start + pos
        best = int(lit_cost[data[abs_pos]] + cost[pos + 1])
        blen_choice, boff_choice = 1, 0
        for (mlen, moff) in matches[pos]:
            # matches may extend past the block boundary; the DP must not
            mlen = min(mlen, blen - pos)
            if mlen < 3:
                continue
            oslot = int(offset_to_slot(np.int64(moff)))
            ocost = int(off_sym_cost[oslot]) + int(OFFSET_SLOT_EXTRA[oslot]) * BIT_COST
            ls = slot_bases[slot_bases <= mlen]
            cand = np.unique(np.concatenate([ls, [mlen]]))
            c = ocost + len_cost[cand] + cost[pos + cand]
            k = int(np.argmin(c))
            if int(c[k]) < best:
                best = int(c[k])
                blen_choice, boff_choice = int(cand[k]), moff
        cost[pos] = best
        choice_len[pos] = blen_choice
        choice_off[pos] = boff_choice
    return choice_len, choice_off, int(cost[0])


def _path_to_items(data, block_start, block_end, choice_len, choice_off):
    kinds, vals, offs = [], [], []
    pos = 0
    blen = block_end - block_start
    while pos < blen:
        L = int(choice_len[pos])
        if L == 1 or choice_off[pos] == 0:
            kinds.append(0)
            vals.append(data[block_start + pos])
            offs.append(0)
            pos += 1
        else:
            kinds.append(1)
            vals.append(L)
            offs.append(int(choice_off[pos]))
            pos += L
    return (
        np.array(kinds, dtype=np.uint8),
        np.array(vals, dtype=np.int32),
        np.array(offs, dtype=np.int32),
    )


def _all_literals_alternative(data, block_start, block_end, kinds, vals, offs):
    """The reference explicitly evaluates an all-literals block shape
    (lib/deflate_compress.c:3437-3466): on literal-heavy blocks dropping
    the length/offset symbols sharpens the literal code enough to beat the
    matchy min-cost path.  Returns the cheaper item set."""
    from .emit import block_histograms

    lf, of = block_histograms(kinds, vals, offs)
    ll = package_merge_lengths(lf, COMPRESSOR_MAX_LITLEN_CODEWORD_LEN)
    ol = package_merge_lengths(of, 15)
    slots = LENGTH_TO_SLOT[np.clip(vals, 3, 258)]
    is_m = kinds == 1
    extra = np.where(
        is_m,
        LENGTH_SLOT_EXTRA[slots]
        + OFFSET_SLOT_EXTRA[offset_to_slot(np.maximum(offs, 1))],
        0,
    )
    path_bits = int((lf * ll[: len(lf)]).sum() + (of * ol[: len(of)]).sum()
                    + extra.sum())

    bh = np.bincount(
        np.frombuffer(data[block_start:block_end], dtype=np.uint8),
        minlength=256,
    ).astype(np.int64)
    fl = np.zeros(288, dtype=np.int64)
    fl[:256] = bh
    fl[END_OF_BLOCK] = 1
    l2 = package_merge_lengths(fl, COMPRESSOR_MAX_LITLEN_CODEWORD_LEN)
    lit_bits = int((fl * l2).sum())
    if lit_bits < path_bits:
        lits = np.frombuffer(data[block_start:block_end], dtype=np.uint8)
        return (
            np.zeros(len(lits), dtype=np.uint8),
            lits.astype(np.int32),
            np.zeros(len(lits), dtype=np.int32),
        )
    return kinds, vals, offs


def compress_near_optimal(data: bytes, level: int) -> bytes:
    p = OPT_PARAMS[level]
    n = len(data)
    w = BitWriter()
    block_start = 0
    mf_state = None
    prev_lens = None
    while block_start < n or n == 0:
        max_block_end = (
            n if n - block_start < SOFT_MAX_BLOCK_LENGTH + 5000
            else block_start + SOFT_MAX_BLOCK_LENGTH
        )
        matches, block_end, mf_state = _collect_matches(
            data, block_start, max_block_end, p["depth"], p["nice"], mf_state
        )
        if block_end > block_start:
            lit_cost, len_sym_cost, off_sym_cost = _seeded_costs(
                data, block_start, block_end, prev_lens
            )
        else:
            lit_cost, len_sym_cost, off_sym_cost = _default_costs()

        best_items = None
        prev_path_cost = None
        for pass_i in range(p["passes"]):
            cl, co, path_cost = _min_cost_path(
                data, block_start, block_end, matches,
                lit_cost, len_sym_cost, off_sym_cost,
            )
            kinds, vals, offs = _path_to_items(data, block_start, block_end, cl, co)
            from .emit import block_histograms

            lf, of = block_histograms(kinds, vals, offs)
            litlen_lens = package_merge_lengths(
                lf, COMPRESSOR_MAX_LITLEN_CODEWORD_LEN
            )
            off_lens = package_merge_lengths(of, 15)
            best_items = (kinds, vals, offs)
            prev_lens = (litlen_lens, off_lens)
            # converged? (the reference's early stop on path cost,
            # lib/deflate_compress.c:3471-3502)
            if prev_path_cost is not None and (
                path_cost + 32 * BIT_COST >= prev_path_cost
            ):
                break
            prev_path_cost = path_cost
            lit_cost, len_sym_cost, off_sym_cost = _costs_from_lens(
                litlen_lens, off_lens
            )

        kinds, vals, offs = best_items
        if block_end > block_start:
            kinds, vals, offs = _all_literals_alternative(
                data, block_start, block_end, kinds, vals, offs
            )
        flush_block(
            w, data[block_start:block_end], kinds, vals, offs,
            is_final=(block_end == n),
        )
        block_start = block_end
        if n == 0:
            break
    return w.finish()
