"""Encode-side Huffman code construction.

Role parity with the reference's ``deflate_make_huffman_code``
(``lib/deflate_compress.c:1318-1396``): given symbol frequencies, produce
length-limited codeword lengths and emit-ready (bit-reversed) codewords.

Design difference (TPU-first, not a port): instead of the reference's
heapsort + parentless-tree + depth-fixup heuristic, we use the
**package-merge** algorithm, which yields *optimal* length-limited codes
(compressed size <= the reference's heuristic for the same frequencies) and
vectorizes naturally: each list level is a NumPy merge of weight vectors and
symbol-count matrices, with no pointer-chasing tree.

Edge-case contract kept from the reference (lib/deflate_compress.c:1342-1378):
when fewer than 2 distinct symbols are used, we still emit two length-1
codewords so that table-driven decoders (including zlib) accept the code.

The port's own copy of ``libdeflate_tpu/huffman/build.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..formats.deflate import canonical_codes, reverse_bits


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited codeword lengths via package-merge.

    Parameters
    ----------
    freqs : int array [num_syms] — symbol frequencies (>=0)
    max_len : codeword length limit (e.g. 7 for the precode, 14 for litlen,
        15 for offsets)

    Returns int32 array of codeword lengths (0 for unused symbols).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    num_syms = freqs.shape[0]
    used = np.flatnonzero(freqs > 0)
    n = used.shape[0]
    lens = np.zeros(num_syms, dtype=np.int32)

    if n == 0:
        # No symbols: give symbols 0 and 1 one-bit codewords (decoder compat).
        lens[0] = 1
        lens[1] = 1
        return lens
    if n == 1:
        s = int(used[0])
        lens[s] = 1
        lens[1 if s == 0 else 0] = 1
        return lens
    if n > (1 << max_len):
        raise ValueError("too many symbols for length limit")

    # Item weights sorted ascending; C tracks how many of each *used* symbol a
    # package contains.  Stable sort keeps determinism.
    order = np.argsort(freqs[used], kind="stable")
    item_w = freqs[used][order]                      # [n]
    item_c = np.eye(n, dtype=np.int32)               # [n, n]

    level_w = item_w.copy()
    level_c = item_c.copy()
    for _ in range(max_len - 1):
        # Package: pair adjacent entries (drop a trailing odd one).
        m = level_w.shape[0] // 2
        pack_w = level_w[: 2 * m : 2] + level_w[1 : 2 * m : 2]
        pack_c = level_c[: 2 * m : 2] + level_c[1 : 2 * m : 2]
        # Merge with the original items.
        w = np.concatenate([item_w, pack_w])
        c = np.concatenate([item_c, pack_c], axis=0)
        o = np.argsort(w, kind="stable")
        level_w = w[o]
        level_c = c[o]

    # The optimal solution selects the first 2(n-1) packages of the last list;
    # each symbol's codeword length = how many selected packages contain it.
    sel = level_c[: 2 * (n - 1)].sum(axis=0)
    lens[used[order]] = sel
    return lens


def make_huffman_code(
    freqs: np.ndarray, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Build (lens, emit-ready codewords) for a frequency table.

    Codewords are canonical (RFC 1951 §3.2.2) and pre-bit-reversed for
    LSB-first emission.
    """
    lens = package_merge_lengths(freqs, max_len)
    codes = reverse_bits(canonical_codes(lens), lens.astype(np.uint32))
    return lens, codes
