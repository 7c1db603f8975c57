"""Host LZ77 parsers: greedy and lazy hash-chain matchfinding.

Algorithmic parity with the reference's matchfinder family:

- level 1: hash-table greedy with tiny search depth (ht_matchfinder role,
  ``lib/ht_matchfinder.h``)
- levels 2-4: hash-chain greedy (hc_matchfinder + deflate_compress_greedy,
  ``lib/deflate_compress.c:2528-2602``)
- levels 5-9: hash-chain lazy with 1-position lookahead and the reference's
  "better match" comparison ``4*(next_len-cur_len) + bsr(cur_off) -
  bsr(next_off) > 2`` (``lib/deflate_compress.c:2722-2725``)

This is the correctness-first host path; the TPU pipeline
(compress/tpu_pipeline.py) re-derives matchfinding as sorted-neighbor
candidate arrays, and a C++ native backend accelerates this host path.

Hash function parity: multiplicative hash ``seq * 0x1E35A7BD`` with the high
bits kept (lib/matchfinder_common.h:168-172).

The port's own copy of ``libdeflate_tpu/compress/parse_host.py``, whole.
"""

from __future__ import annotations

import numpy as np

MULT = 0x1E35A7BD
HASH4_ORDER = 15
HASH3_ORDER = 14
WINDOW = 32768
MAX_LEN = 258


def _hashes(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized 4-byte and 3-byte rolling hashes for every position."""
    b = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
    n = len(b)
    u32 = np.zeros(n, dtype=np.uint32)
    if n >= 4:
        u32[: n - 3] = (
            b[: n - 3]
            | (b[1 : n - 2] << np.uint32(8))
            | (b[2 : n - 1] << np.uint32(16))
            | (b[3:n] << np.uint32(24))
        )
    u24 = u32 & np.uint32(0xFFFFFF)
    h4 = ((u32 * np.uint32(MULT)) >> np.uint32(32 - HASH4_ORDER)).astype(np.int64)
    h3 = ((u24 * np.uint32(MULT)) >> np.uint32(32 - HASH3_ORDER)).astype(np.int64)
    return h4, h3


def _lcp(data: bytes, i: int, j: int, limit: int) -> int:
    """Longest common prefix of data[i:] and data[j:], capped at limit.

    Uses C-speed slice comparisons with doubling instead of a byte loop
    (the reference's word-at-a-time lz_extend analogue)."""
    l = 0
    step = 16
    while l < limit:
        s = min(step, limit - l)
        if data[i + l : i + l + s] == data[j + l : j + l + s]:
            l += s
            step = min(step * 2, 256)
        else:
            # refine within this window
            a = data[i + l : i + l + s]
            c = data[j + l : j + l + s]
            for k in range(s):
                if a[k] != c[k]:
                    return l + k
            return l + s
    return limit


class LevelParams:
    def __init__(self, kind, max_search_depth, nice_match_length, min_match_len=3):
        self.kind = kind  # 'greedy' | 'lazy' | 'lazy2'
        self.max_search_depth = max_search_depth
        self.nice_match_length = nice_match_length
        self.min_match_len = min_match_len


# Per-level parameters: contract parity with the reference's level table
# (lib/deflate_compress.c:3927-4013).  Levels 10-12 use the near-optimal
# parser (parse_optimal.py); its matchfinding parameters live there.
LEVEL_PARAMS = {
    1: LevelParams("greedy", 2, 32, min_match_len=4),
    2: LevelParams("greedy", 6, 10),
    3: LevelParams("greedy", 12, 14),
    4: LevelParams("greedy", 16, 30),
    5: LevelParams("lazy", 16, 30),
    6: LevelParams("lazy", 35, 65),
    7: LevelParams("lazy", 100, 130),
    8: LevelParams("lazy2", 300, MAX_LEN),
    9: LevelParams("lazy2", 600, MAX_LEN),
}


class HashChains:
    """Sequential-insert hash-chain matchfinder state."""

    __slots__ = ("head4", "prev4", "head3", "data", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.head4 = np.full(1 << HASH4_ORDER, -1, dtype=np.int64)
        self.prev4 = np.full(max(self.n, 1), -1, dtype=np.int64)
        self.head3 = np.full(1 << HASH3_ORDER, -1, dtype=np.int64)

    def insert(self, pos: int, h4: np.ndarray, h3: np.ndarray) -> None:
        h = h4[pos]
        self.prev4[pos] = self.head4[h]
        self.head4[h] = pos
        self.head3[h3[pos]] = pos

    def longest_match(
        self, pos: int, h4, h3, max_depth: int, nice_len: int, best_len_in: int = 2
    ) -> tuple[int, int]:
        """Best (length, offset) at pos; (0,0) if none >= 3."""
        data, n = self.data, self.n
        limit = min(MAX_LEN, n - pos)
        if limit < 3:
            return (0, 0)
        best_len, best_off = best_len_in, 0
        nice = min(nice_len, limit)

        # Nearest length-3 candidate via the hash3 table (hc_matchfinder's
        # singleton len-3 path, lib/hc_matchfinder.h:219-256 role).
        j = int(self.head3[h3[pos]])
        if j >= 0 and pos - j <= WINDOW:
            l = _lcp(data, pos, j, limit)
            if l >= 3 and l > best_len:
                best_len, best_off = l, pos - j

        depth = max_depth
        j = int(self.head4[h4[pos]])
        while j >= 0 and pos - j <= WINDOW and depth > 0 and best_len < nice:
            # quick reject: check byte at best_len before a full extend
            if (
                pos + best_len < n
                and j + best_len < n
                and data[j + best_len] == data[pos + best_len]
            ):
                l = _lcp(data, pos, j, limit)
                if l > best_len and l >= 4:
                    best_len, best_off = l, pos - j
            j = int(self.prev4[j])
            depth -= 1
        if best_off == 0 or best_len < 3:
            return (0, 0)
        return (best_len, best_off)


def _bsr(x: int) -> int:
    return x.bit_length() - 1


def _choose_min_len(used: int, depth: int) -> int:
    """Adaptive minimum match length from the distinct-literal count
    (policy parity: choose_min_match_len / calculate_min_match_len,
    lib/deflate_compress.c:2295-2378): tiny alphabets make short matches
    cost more bits than the literals they replace."""
    m = (9 if used <= 5 else 8 if used <= 7 else 7 if used <= 9 else
         6 if used <= 15 else 5 if used <= 44 else 4 if used <= 79 else 3)
    if depth < 5:
        m = min(m, 4)
    elif depth < 10:
        m = min(m, 5)
    elif depth < 16:
        m = min(m, 7)
    return m


_MINLEN_SEG = 32768  # recalc cadence (the reference recalcs at block starts)


def _adaptive_min_lens(data: bytes, depth: int) -> np.ndarray:
    """min_match_len per 32 KiB input segment, each from the distinct-byte
    count of the segment's first 4 KiB (the reference samples the next
    4 KiB at each block start, lib/deflate_compress.c:2329-2353)."""
    n = len(data)
    if n < 512:
        return np.full(1, 3, dtype=np.int32)
    nseg = -(-n // _MINLEN_SEG)
    b = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(nseg, dtype=np.int32)
    for s in range(nseg):
        w = b[s * _MINLEN_SEG: s * _MINLEN_SEG + 4096]
        used = int(np.count_nonzero(np.bincount(w, minlength=256)))
        out[s] = _choose_min_len(used, depth)
    return out


def parse(data: bytes, params: LevelParams) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a buffer into LZ77 items (kinds, vals, offs)."""
    n = len(data)
    h4, h3 = _hashes(data)
    mf = HashChains(data)
    kinds: list[int] = []
    vals: list[int] = []
    offs: list[int] = []

    depth = params.max_search_depth
    nice = params.nice_match_length
    lazy = params.kind in ("lazy", "lazy2")
    # levels 2-9 adapt min_match_len to the local alphabet size; level 1
    # keeps its fixed ht-matchfinder minimum of 4
    if params.min_match_len > 3:
        min_lens = np.full(1 + (n >> 15), params.min_match_len, np.int32)
    else:
        min_lens = _adaptive_min_lens(data, depth)

    i = 0
    end_matchable = n - 3
    while i < n:
        if i >= end_matchable:
            kinds.append(0)
            vals.append(data[i])
            offs.append(0)
            i += 1
            continue
        min_len = int(min_lens[i >> 15])
        length, offset = mf.longest_match(i, h4, h3, depth, nice, min_len - 1)
        mf.insert(i, h4, h3)
        if length < min_len:
            kinds.append(0)
            vals.append(data[i])
            offs.append(0)
            i += 1
            continue

        if lazy:
            # Slide the match forward while a strictly better one exists at
            # the next position (reference lazy loop, deflate_compress.c:2604);
            # lazy2 (levels 8-9) looks one further position ahead at quarter
            # depth with a stricter threshold (deflate_compress.c:2742-2766).
            while length < nice and i + 1 < end_matchable:
                nlen, noff = mf.longest_match(
                    i + 1, h4, h3, max(depth // 2, 1), nice, length
                )
                if nlen > length and (
                    4 * (nlen - length) + _bsr(offset) - _bsr(noff) > 2
                ):
                    kinds.append(0)
                    vals.append(data[i])
                    offs.append(0)
                    i += 1
                    mf.insert(i, h4, h3)
                    length, offset = nlen, noff
                    continue
                if params.kind == "lazy2" and i + 2 < end_matchable:
                    n2, o2 = mf.longest_match(
                        i + 2, h4, h3, max(depth // 4, 1), nice, length
                    )
                    if n2 > length and (
                        4 * (n2 - length) + _bsr(offset) - _bsr(o2) > 6
                    ):
                        kinds.extend((0, 0))
                        vals.extend((data[i], data[i + 1]))
                        offs.extend((0, 0))
                        mf.insert(i + 1, h4, h3)
                        mf.insert(i + 2, h4, h3)
                        i += 2
                        length, offset = n2, o2
                        continue
                break

        kinds.append(1)
        vals.append(length)
        offs.append(offset)
        # Insert skipped positions so later searches can find them.
        stop = min(i + length, end_matchable)
        for p in range(i + 1, stop):
            mf.insert(p, h4, h3)
        i += length

    return (
        np.array(kinds, dtype=np.uint8),
        np.array(vals, dtype=np.int32),
        np.array(offs, dtype=np.int32),
    )
