"""The port's format copies and host helpers against the JAX package's.

``libdeflate_tpu_torch.formats`` (``deflate``, ``zlib_fmt``, ``gzip_fmt``),
``ops.checksums_host.adler32_combine``, ``compress.emit.BitWriter``,
``parallel.file_codec.stored_fragment``, ``parallel.mesh.pad_chunks`` and
the ``*_compress_bound`` helpers, each held to its original in
``libdeflate_tpu`` (and to zlib where zlib can say) on the same inputs.
All host-only integer code: tolerance exact.
"""

import zlib

import numpy as np
import pytest

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from libdeflate_tpu.compress import emit as jemit
from libdeflate_tpu.formats import deflate as jdeflate
from libdeflate_tpu.formats import gzip_fmt as jgzip
from libdeflate_tpu.formats import zlib_fmt as jzlib
from libdeflate_tpu.ops import checksums_host as jch
from libdeflate_tpu.parallel import file_codec as jfc
from libdeflate_tpu.parallel import mesh as jmesh
from libdeflate_tpu_torch.compress import emit
from libdeflate_tpu_torch.formats import deflate, gzip_fmt, zlib_fmt
from libdeflate_tpu_torch.ops import checksums_host
from libdeflate_tpu_torch.parallel import file_codec, mesh

LEVELS = range(-1, 14)


def _constants(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, int)}


@pytest.mark.parametrize("port,ref", [(zlib_fmt, jzlib), (gzip_fmt, jgzip)],
                         ids=["zlib", "gzip"])
def test_container_constants_equal(port, ref):
    assert _constants(port) == _constants(ref)


def test_deflate_constants_equal():
    names = ("BLOCKTYPE_UNCOMPRESSED", "MIN_BLOCK_LENGTH")
    assert {k: getattr(deflate, k) for k in names} == \
        {k: getattr(jdeflate, k) for k in names}


@pytest.mark.parametrize("level", LEVELS)
def test_headers_equal(level):
    assert zlib_fmt.level_hint(level) == jzlib.level_hint(level)
    assert zlib_fmt.make_header(level) == jzlib.make_header(level)
    assert gzip_fmt.make_header(level) == jgzip.make_header(level)
    # each header parses, by the port's parser and by zlib's
    assert zlib_fmt.parse_header(zlib_fmt.make_header(level)) == 2
    assert gzip_fmt.parse_header(gzip_fmt.make_header(level) + bytes(8)) \
        == gzip_fmt.MIN_HEADER_SIZE
    assert zlib.decompress(zlib_fmt.make_header(level) + b"\x03\x00"
                           + zlib_fmt.make_trailer(1)) == b""


@pytest.mark.parametrize("value", [0, 1, 0xFFFF, 0xFFFFFFFF, 1 << 32,
                                   (1 << 40) + 5, 0x12345678])
def test_trailers_equal(value):
    assert zlib_fmt.make_trailer(value) == jzlib.make_trailer(value)
    for isize in (0, value, 0xFFFFFFFF, (1 << 32) + 7):
        assert gzip_fmt.make_trailer(value, isize) == \
            jgzip.make_trailer(value, isize)


def test_zlib_parse_header_every_two_bytes():
    for hdr in range(1 << 16):
        b = hdr.to_bytes(2, "big")
        assert zlib_fmt.parse_header(b) == jzlib.parse_header(b), hex(hdr)
    for b in (b"", b"\x78"):
        assert zlib_fmt.parse_header(b) is jzlib.parse_header(b) is None


def _gzip_headers():
    """Headers with every combination of FTEXT, FHCRC, FEXTRA, FNAME and
    FCOMMENT, one with a reserved bit, a wrong magic and a wrong CM, each
    followed by an 8-byte footer."""
    rng = np.random.default_rng(11)
    out = []
    for flg in range(32):
        h = bytes([0x1F, 0x8B, 8, flg]) + bytes(6)
        if flg & gzip_fmt.FEXTRA:
            xlen = int(rng.integers(0, 40))
            h += xlen.to_bytes(2, "little") + rng.bytes(xlen)
        if flg & gzip_fmt.FNAME:
            h += b"name.txt\x00"
        if flg & gzip_fmt.FCOMMENT:
            h += b"a comment\x00"
        if flg & gzip_fmt.FHCRC:
            h += b"\x12\x34"
        out.append(h + bytes(8))
    out.append(bytes([0x1F, 0x8B, 8, 0x20]) + bytes(14))
    out.append(bytes([0x1F, 0x8C, 8, 0]) + bytes(14))
    out.append(bytes([0x1F, 0x8B, 7, 0]) + bytes(14))
    # a name with no terminator, an extra field longer than the data
    out.append(bytes([0x1F, 0x8B, 8, gzip_fmt.FNAME]) + bytes(6) + b"abc"
               + b"\x01" * 8)
    out.append(bytes([0x1F, 0x8B, 8, gzip_fmt.FEXTRA]) + bytes(6)
               + (500).to_bytes(2, "little") + bytes(20))
    return out


def test_gzip_parse_header_flags_and_truncations():
    headers = _gzip_headers()
    parsed = 0
    for h in headers:
        for cut in range(len(h) + 1):
            assert gzip_fmt.parse_header(h[:cut]) == \
                jgzip.parse_header(h[:cut]), (h, cut)
        parsed += gzip_fmt.parse_header(h) is not None
    assert parsed == 32


def test_parse_header_of_the_ports_own_output():
    data = b"parse me " * 40
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    for level in (0, 1, 6, 9, 12):
        gz = (gzip_fmt.make_header(level) + raw
              + gzip_fmt.make_trailer(zlib.crc32(data), len(data)))
        assert gzip_fmt.parse_header(gz) == jgzip.parse_header(gz) == 10
        assert zlib.decompress(gz, 31) == data
        zl = (zlib_fmt.make_header(level) + raw
              + zlib_fmt.make_trailer(zlib.adler32(data)))
        assert zlib_fmt.parse_header(zl) == jzlib.parse_header(zl) == 2
        assert zlib.decompress(zl) == data


@pytest.mark.parametrize("n", [0, 1, 4999, 5000, 5001, 10 ** 7])
def test_compress_bounds_equal(n):
    assert deflate.deflate_compress_bound(n) == \
        jdeflate.deflate_compress_bound(n)
    for name in ("deflate_compress_bound", "zlib_compress_bound",
                 "gzip_compress_bound"):
        for level in (None, 1, 12):
            assert getattr(lt, name)(n, level) == getattr(ld, name)(n, level)


def test_adler32_combine_random_splits():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    cuts = [0, 1, 5551, 5552, 65521, 65522, 131042, len(data)]
    cuts += rng.integers(0, len(data), 40).tolist()
    for c in cuts:
        a, b = data[:c], data[c:]
        want = zlib.adler32(data)
        got = checksums_host.adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                             len(b))
        assert got == jch.adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                          len(b)) == want, c
    # checksums at their edges, and lengths past the modulus
    for a1 in (1, 0, 0xFFF0FFF0, 0x0001FFF0):
        for a2 in (1, 0xFFF0FFF0, 0x00010000):
            for n in (0, 1, 65521, 65522, 1 << 33):
                assert checksums_host.adler32_combine(a1, a2, n) == \
                    jch.adler32_combine(a1, a2, n)


def _write_ops(w, ops):
    for op, *args in ops:
        getattr(w, op)(*args)
    return w.finish()


def test_bitwriter_equal():
    rng = np.random.default_rng(9)
    ops = []
    for _ in range(3000):
        r = rng.random()
        if r < 0.8:
            nbits = int(rng.integers(0, 33))
            ops.append(("add", int(rng.integers(0, 1 << nbits)), nbits))
        else:
            ops.append(("align_to_byte",))
    ops.append(("add", 1, 3))
    assert _write_ops(emit.BitWriter(), ops) == \
        _write_ops(jemit.BitWriter(), ops)


@pytest.mark.parametrize("n", [0, 1, 65535, 65536, 140000])
@pytest.mark.parametrize("bfinal", [False, True])
def test_stored_fragment_equal(n, bfinal):
    chunk = np.random.default_rng(n).integers(0, 256, n,
                                              dtype=np.uint8).tobytes()
    frag = file_codec.stored_fragment(chunk, bfinal)
    assert frag == jfc.stored_fragment(chunk, bfinal)
    d = zlib.decompressobj(-15)
    assert d.decompress(frag) == chunk
    assert d.eof == bfinal


@pytest.mark.parametrize("n,chunk,mult", [
    (0, 512, 8), (1, 512, 8), (512, 512, 8), (513, 512, 1), (4095, 512, 3),
    (8 * 512, 512, 8), (8 * 512 + 17, 512, 8), (100000, 16384, 8)])
def test_pad_chunks_equal(n, chunk, mult):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    got = mesh.pad_chunks(data, chunk, mult)
    want = jmesh.pad_chunks(data, chunk, mult)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]
