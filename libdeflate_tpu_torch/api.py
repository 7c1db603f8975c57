"""The libdeflate contract's compressed-size bounds.

The part of ``libdeflate_tpu/api.py`` (lines 28-38) that the port has so
far: the three ``*_compress_bound`` helpers, pure integer rules.
``level`` is accepted and ignored, as there.  The ``Compressor`` and
``Decompressor`` classes run the JAX package's host engine and are not
ported yet.
"""

from __future__ import annotations

from .formats import gzip_fmt, zlib_fmt
from .formats.deflate import deflate_compress_bound as _raw_bound


def deflate_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return _raw_bound(in_nbytes)


def zlib_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return zlib_fmt.MIN_OVERHEAD + _raw_bound(in_nbytes)


def gzip_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return gzip_fmt.MIN_OVERHEAD + _raw_bound(in_nbytes)
