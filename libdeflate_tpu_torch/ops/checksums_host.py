"""Host-side checksum combine.

The port's own copy of ``adler32_combine``
(``libdeflate_tpu/ops/checksums_host.py:99-108``), which the whole-file
codec uses to join per-chunk device Adler-32s; ``crc32_combine`` is in
``ops/crc32_math.py``.
"""

from __future__ import annotations

from .checksums import ADLER_MOD


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
