"""Public API: the libdeflate contract, one class per codec direction.

Mirrors the 22 exported ``libdeflate_*`` entry points (``libdeflate.h``; see
SURVEY.md §2.1): 3 formats x {compress, decompress, bound}, 2 checksums,
level rules (0-12, -1 aliases 6, out-of-range rejected), result codes, and
the known-size vs unknown-size decompression modes.

The compute backend defaults to the host path; the CUDA chunk-parallel paths
live in ``libdeflate_tpu_torch.parallel`` and share these format wrappers.

The port's own copy of ``libdeflate_tpu/api.py``, whole, over the port's own
host engine (``compress/engine.py``, ``decompress/host.py``,
``native_backend.py``, ``ops/checksums_host.py``).  Like the JAX entry
points, these run on the host and take no device.
"""

from __future__ import annotations

from .compress.engine import deflate_compress as _deflate_compress
from .compress.engine import normalize_level
from .decompress import host as _dhost
from .formats import gzip_fmt, zlib_fmt
from .formats.deflate import deflate_compress_bound as _raw_bound
from .ops.checksums_host import adler32, adler32_combine, crc32  # noqa: F401
from .ops.crc32_math import crc32_combine  # noqa: F401

SUCCESS = 0
BAD_DATA = 1
SHORT_OUTPUT = 2
INSUFFICIENT_SPACE = 3


def deflate_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return _raw_bound(in_nbytes)


def zlib_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return zlib_fmt.MIN_OVERHEAD + _raw_bound(in_nbytes)


def gzip_compress_bound(in_nbytes: int, level: int | None = None) -> int:
    return gzip_fmt.MIN_OVERHEAD + _raw_bound(in_nbytes)


class Compressor:
    """Compressor object (parity: libdeflate_alloc_compressor).

    Raises ValueError for out-of-range levels (the C API returns NULL).
    """

    def __init__(self, level: int = 6):
        lvl = normalize_level(level)
        if lvl is None:
            raise ValueError(f"invalid compression level {level}")
        self.level = lvl

    # -- raw DEFLATE --------------------------------------------------------
    def deflate_compress(self, data, out_nbytes_avail: int | None = None) -> bytes:
        """Compress; returns b'' if the result wouldn't fit in
        out_nbytes_avail (the C 0-return contract)."""
        data = bytes(data)
        out = _deflate_compress(data, self.level)
        if out_nbytes_avail is not None and len(out) > out_nbytes_avail:
            return b""
        return out

    def deflate_compress_bound(self, in_nbytes: int) -> int:
        return _raw_bound(in_nbytes)

    # -- zlib ---------------------------------------------------------------
    def zlib_compress(self, data, out_nbytes_avail: int | None = None) -> bytes:
        data = bytes(data)
        if out_nbytes_avail is not None and out_nbytes_avail <= zlib_fmt.MIN_OVERHEAD:
            return b""
        raw = self.deflate_compress(
            data,
            None
            if out_nbytes_avail is None
            else out_nbytes_avail - zlib_fmt.MIN_OVERHEAD,
        )
        if raw == b"":
            # the engine's empty return always means "did not fit" — even an
            # empty input costs a 5-byte stored block (the reference's
            # 0-return contract, libdeflate.h:70-88)
            return b""
        return (
            zlib_fmt.make_header(self.level)
            + raw
            + zlib_fmt.make_trailer(adler32(data))
        )

    def zlib_compress_bound(self, in_nbytes: int) -> int:
        return zlib_compress_bound(in_nbytes)

    # -- gzip ---------------------------------------------------------------
    def gzip_compress(self, data, out_nbytes_avail: int | None = None) -> bytes:
        data = bytes(data)
        if out_nbytes_avail is not None and out_nbytes_avail <= gzip_fmt.MIN_OVERHEAD:
            return b""
        raw = self.deflate_compress(
            data,
            None
            if out_nbytes_avail is None
            else out_nbytes_avail - gzip_fmt.MIN_OVERHEAD,
        )
        if raw == b"":
            return b""
        return (
            gzip_fmt.make_header(self.level)
            + raw
            + gzip_fmt.make_trailer(crc32(data), len(data))
        )

    def gzip_compress_bound(self, in_nbytes: int) -> int:
        return gzip_compress_bound(in_nbytes)

    def get_compression_level(self) -> int:
        """Parity: libdeflate_get_compression_level
        (lib/deflate_compress.c:4081-4085)."""
        return self.level

    # -- convenience --------------------------------------------------------
    def compress(self, data, fmt: str = "deflate") -> bytes:
        return {
            "deflate": self.deflate_compress,
            "zlib": self.zlib_compress,
            "gzip": self.gzip_compress,
        }[fmt](data)


class Decompressor:
    """Decompressor object (parity: libdeflate_alloc_decompressor).

    All methods return ``(result, out_bytes|None, actual_in, actual_out)``.
    ``known_size=True`` replicates passing NULL for actual_out_nbytes_ret:
    the output must fill out_nbytes_avail exactly (else SHORT_OUTPUT).
    """

    def deflate_decompress(
        self, data, out_nbytes_avail: int, known_size: bool = False
    ):
        from . import native_backend

        if native_backend.available():
            return native_backend.deflate_decompress(
                bytes(data), out_nbytes_avail, known_size
            )
        return _dhost.deflate_decompress(bytes(data), out_nbytes_avail, known_size)

    def zlib_decompress(
        self, data, out_nbytes_avail: int, known_size: bool = False
    ):
        data = bytes(data)
        hlen = zlib_fmt.parse_header(data)
        if hlen is None or len(data) < zlib_fmt.MIN_OVERHEAD:
            return (BAD_DATA, None, 0, 0)
        body = data[hlen : ]
        res, out, ain, aout = self.deflate_decompress(
            body, out_nbytes_avail, known_size
        )
        if res != SUCCESS:
            return (res, None, 0, 0)
        if len(body) - ain < 4:
            return (BAD_DATA, None, 0, 0)
        stored = int.from_bytes(body[ain : ain + 4], "big")
        if stored != adler32(out):
            return (BAD_DATA, None, 0, 0)
        return (SUCCESS, out, hlen + ain + 4, aout)

    def gzip_decompress(
        self, data, out_nbytes_avail: int, known_size: bool = False
    ):
        """Decompress the *first* gzip member (use actual_in for multi-member
        streams, as with libdeflate_gzip_decompress_ex)."""
        data = bytes(data)
        if len(data) < gzip_fmt.MIN_OVERHEAD:
            return (BAD_DATA, None, 0, 0)
        hlen = gzip_fmt.parse_header(data)
        if hlen is None:
            return (BAD_DATA, None, 0, 0)
        body = data[hlen : len(data) - gzip_fmt.FOOTER_SIZE]
        res, out, ain, aout = self.deflate_decompress(
            body, out_nbytes_avail, known_size
        )
        if res != SUCCESS:
            return (res, None, 0, 0)
        footer = data[hlen + ain : hlen + ain + 8]
        if len(footer) < 8:
            return (BAD_DATA, None, 0, 0)
        if int.from_bytes(footer[:4], "little") != crc32(out):
            return (BAD_DATA, None, 0, 0)
        if int.from_bytes(footer[4:], "little") != (aout & 0xFFFFFFFF):
            return (BAD_DATA, None, 0, 0)
        return (SUCCESS, out, hlen + ain + 8, aout)

    def decompress(self, data, out_nbytes_avail: int, fmt: str = "deflate",
                   known_size: bool = False):
        return {
            "deflate": self.deflate_decompress,
            "zlib": self.zlib_decompress,
            "gzip": self.gzip_decompress,
        }[fmt](data, out_nbytes_avail, known_size)
