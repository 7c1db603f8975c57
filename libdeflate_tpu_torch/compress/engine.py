"""DEFLATE compressor engine: level dispatch, blocking, stored passthrough.

Contract parity with ``libdeflate_deflate_compress``
(``lib/deflate_compress.c:4030-4072``) and the level table at
``lib/deflate_compress.c:3927-4013``: levels 0-12 (-1 aliases 6), tiny inputs
pass through as stored blocks (``max_passthrough_size = 55 - 4*level``),
level 0 emits stored blocks only.

The port's own copy of ``libdeflate_tpu/compress/engine.py``, whole but for
``_split_items_by_input_len``, which nothing there calls.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import SOFT_MAX_BLOCK_LENGTH
from . import parse_host
from .emit import BitWriter, emit_stored, flush_block

MIN_LEVEL = 0
MAX_LEVEL = 12
DEFAULT_LEVEL = 6


def normalize_level(level: int) -> int | None:
    if level == -1:
        level = DEFAULT_LEVEL
    if level < MIN_LEVEL or level > MAX_LEVEL:
        return None
    return level


def max_passthrough_size(level: int) -> int:
    if level == 0:
        return 2**63
    return 55 - level * 4


def _compress_stored(data: bytes) -> bytes:
    w = BitWriter()
    emit_stored(w, data, is_final=True)
    return w.finish()


# Block-split heuristic constants (lib/deflate_compress.c:2141-2197):
# 10 observation classes, a check every 512 observations, split when the
# probability-delta sum crosses 200/512 with short-block penalties.
_OBS_CHECK = 512
_MIN_BLOCK = 5000


def _split_items_by_stats(kinds, vals, soft_max: int):
    """Yield item-range blocks chosen by the reference's online
    distribution-shift heuristic (should_end_block,
    lib/deflate_compress.c:2141-2218): every item is one observation (8
    literal classes by bits 7-6 and 0, 2 match classes by len >= 9); every
    512 observations the new distribution is compared against the block's
    accumulated one and the block ends when the delta crosses the cutoff.
    Matches the native codec's BlockStats (native/ldtpu_native.cpp) so
    forced-dispatch output tracks the native streams."""
    n_items = len(kinds)
    spans = np.where(kinds == 1, vals, 1).astype(np.int64)
    csum = np.cumsum(spans)
    total_in = int(csum[-1]) if n_items else 0
    cls = np.where(
        kinds == 1, 8 + (vals >= 9).astype(np.int64),
        ((vals.astype(np.int64) >> 5) & 6) | (vals.astype(np.int64) & 1),
    )
    start = 0
    base = 0
    while start < n_items:
        obs = np.zeros(10, dtype=np.int64)
        num = 0
        cut = start
        while True:
            nxt = min(cut + _OBS_CHECK, n_items)
            newo = np.bincount(cls[cut:nxt], minlength=10)
            num_new = nxt - cut
            cut = nxt
            in_here = int(csum[cut - 1]) - base
            if cut >= n_items or in_here >= soft_max:
                break
            remaining = total_in - base - in_here
            if num_new >= _OBS_CHECK and in_here >= _MIN_BLOCK and remaining >= _MIN_BLOCK and num > 0:
                delta = np.abs(newo * num - obs * num_new)
                total_delta = int(delta.sum())
                num_items = num + num_new
                cutoff = (num_new * 200 // _OBS_CHECK) * num
                if in_here < 10000 and num_items < 8192:
                    cutoff += cutoff * (8192 - num_items) // 8192
                if total_delta + (in_here // 4096) * num >= cutoff:
                    break
            obs += newo
            num += num_new
        yield start, cut, base, int(csum[cut - 1])
        base = int(csum[cut - 1])
        start = cut


def deflate_compress(data: bytes, level: int) -> bytes:
    """Compress to a raw DEFLATE stream; returns the full stream bytes.

    (The size-vs-out_avail 0-return contract is applied by the API layer.)

    Backend dispatch (the analogue of the reference's runtime SIMD dispatch,
    lib/deflate_compress.c:454-458): the native C++ codec when available,
    else the pure-Python host path.  LIBDEFLATE_TPU_NO_NATIVE=1 forces
    Python, exercising both paths like LIBDEFLATE_DISABLE_CPU_FEATURES does
    for the reference's kernel variants.
    """
    if len(data) <= max_passthrough_size(level):
        return _compress_stored(data)

    if level >= 1:
        from .. import native_backend

        if native_backend.available():
            from ..formats.deflate import deflate_compress_bound

            out = native_backend.deflate_compress(
                data, level, deflate_compress_bound(len(data))
            )
            if out:
                return out

    if level >= 10:
        from .parse_optimal import compress_near_optimal

        return compress_near_optimal(data, level)

    params = parse_host.LEVEL_PARAMS[level]
    kinds, vals, offs = parse_host.parse(data, params)

    w = BitWriter()
    n_items = len(kinds)
    for start, cut, in_base, in_end in _split_items_by_stats(
        kinds, vals, SOFT_MAX_BLOCK_LENGTH
    ):
        flush_block(
            w,
            data[in_base:in_end],
            kinds[start:cut],
            vals[start:cut],
            offs[start:cut],
            is_final=(cut == n_items),
        )
    if n_items == 0:
        emit_stored(w, b"", is_final=True)
    return w.finish()
