"""Host (NumPy) checksum implementations.

API parity: ``libdeflate_adler32`` (init 1, NULL->init; ``lib/adler32.c``) and
``libdeflate_crc32`` (init 0, pre/post inversion inside; ``lib/crc32.c``).

These are vectorized array formulations — the same math the JAX kernels use —
so host and device paths are cross-checked by the test suite the way the
reference cross-checks its dispatched SIMD variants against zlib
(programs/test_checksums.c).

The port's own copy of ``libdeflate_tpu/ops/checksums_host.py``, whole;
``ADLER_MOD`` is the one ``ops/checksums.py`` holds.
"""

from __future__ import annotations

import numpy as np

from .checksums import ADLER_MOD
from .crc32_math import ADVANCE_POW2, CRC_BYTE_TABLE, mat_vec


def adler32(data, adler: int = 1) -> int:
    """Adler-32 as two closed-form weighted sums (no per-byte loop).

    s1' = s1 + sum(b);  s2' = s2 + n*s1 + sum((n-i)*b_i)   (all mod 65521)

    Dispatches to the native codec's kernel when available (the runtime-
    dispatch analogue of lib/adler32.c:135-154); the NumPy formulation
    below stays as the forced-dispatch fallback and test cross-check.
    """
    from .. import native_backend

    if native_backend.available():
        return native_backend.adler32(data, adler)
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.shape[0]
    s1 = adler & 0xFFFF
    s2 = (adler >> 16) & 0xFFFF
    if n == 0:
        return (s2 << 16) | s1
    b = buf.astype(np.int64)
    total = int(b.sum())
    # sum((n-i) * b_i) for i in 0..n-1
    weighted = int((b * (np.int64(n) - np.arange(n, dtype=np.int64))).sum())
    s1_new = (s1 + total) % ADLER_MOD
    s2_new = (s2 + n * s1 + weighted) % ADLER_MOD
    return (s2_new << 16) | s1_new


def _crc32_raw_tree(buf: np.ndarray) -> int:
    """raw CRC register of ``buf`` from state 0, via a log-depth GF(2) tree.

    Leaves are single-byte register values T[b]; each level combines equal
    halves with raw(L||R) = A^{|R|} raw(L) XOR raw(R), where A^{|R|} is a
    precomputed constant matrix per level.  Leading zero bytes are the
    identity for raw CRC, so we can pad at the front to a power of two.
    """
    n = buf.shape[0]
    if n == 0:
        return 0
    logn = max(int(n - 1).bit_length(), 0)
    padded = np.zeros(1 << logn, dtype=np.uint8)
    padded[-n:] = buf  # front-pad with zeros (identity for raw CRC)
    v = CRC_BYTE_TABLE[padded]
    for level in range(logn):
        left = v[0::2]
        right = v[1::2]
        # Advance left past 2^level zero bytes, then XOR the right half.
        v = mat_vec(ADVANCE_POW2[level], left) ^ right
    return int(v[0])


def crc32(data, crc: int = 0) -> int:
    """gzip CRC-32 with the standard pre/post inversion.

    crc32(init, M) = ~( A^{|M|} (~init) XOR raw(M) )

    Dispatches to the native slice-by-8 kernel when available (the
    runtime-dispatch analogue of lib/crc32.c:235-254); the GF(2)-tree
    NumPy path stays as the forced-dispatch fallback and cross-check.
    """
    from .. import native_backend

    if native_backend.available():
        return native_backend.crc32(data, crc)
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.shape[0]
    reg = np.uint32(~crc & 0xFFFFFFFF)
    j = 0
    m = n
    while m:
        if m & 1:
            reg = mat_vec(ADVANCE_POW2[j], reg)
        m >>= 1
        j += 1
    raw = _crc32_raw_tree(buf)
    return int(reg ^ np.uint32(raw)) ^ 0xFFFFFFFF


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler-32 of A||B from the two checksums and |B| (zlib-compatible)."""
    rem = len2 % ADLER_MOD
    s1a = adler1 & 0xFFFF
    s2a = (adler1 >> 16) & 0xFFFF
    s1b = adler2 & 0xFFFF
    s2b = (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % ADLER_MOD
    s2 = (s2a + s2b + rem * (s1a - 1)) % ADLER_MOD
    return ((s2 % ADLER_MOD) << 16) | (s1 % ADLER_MOD)
