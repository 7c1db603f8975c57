"""The port's ``Decompressor`` and host checksums against the JAX package's.

``libdeflate_tpu_torch.Decompressor`` must return the
``(result, out, actual_in, actual_out)`` tuple that
``libdeflate_tpu.Decompressor`` returns, in each format and in both size
modes, with both packages on the native codec and then both forced onto
the Python path (``experiments/host_contract.forced_python``): valid
streams, SHORT_OUTPUT, INSUFFICIENT_SPACE, trailing bytes, truncations, a
reserved block type, a bad stored NLEN, an offset before the start, bad
Adler-32 and CRC-32 trailers, a two-member gzip stream, 5001 empty static
blocks, seeded garbage and the seeded damaged set of
``experiments/host_contract.damaged_set``, whose tuples are also held to
``host_engine_pins.json``.  ``crc32``, ``adler32`` and the two combines
are held to the JAX package and to zlib with chained and maximal initial
values and on a misaligned numpy view.  Tolerance: exact.
"""

import json
import zlib

import numpy as np
import pytest

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from libdeflate_tpu import native_backend as jnb
from libdeflate_tpu_torch import native_backend as nb
from libdeflate_tpu_torch.compress import emit
from libdeflate_tpu_torch.experiments import host_contract as hc
from libdeflate_tpu_torch.experiments.corpus import make_corpus
from libdeflate_tpu_torch.formats.deflate import (
    STATIC_LITLEN_CODES,
    STATIC_LITLEN_LENS,
    STATIC_OFFSET_CODES,
)

BACKENDS = ("native", "python")
CORPUS = make_corpus()
TEXT = CORPUS[:40000]


def on(backend: str):
    """Both packages on ``backend`` for the block."""
    return hc.on_backend(backend, nb, jnb)


def _static_block(w, final: bool, syms) -> None:
    w.add(int(final), 1)
    w.add(1, 2)
    for code, nbits in syms:
        w.add(code, nbits)
    w.add(int(STATIC_LITLEN_CODES[256]), int(STATIC_LITLEN_LENS[256]))


def _lit(c: int):
    return int(STATIC_LITLEN_CODES[c]), int(STATIC_LITLEN_LENS[c])


def _gz(x: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    return co.compress(x) + co.flush()


def _crafted() -> dict[str, tuple[str, bytes, int]]:
    """(format, stream, out_nbytes_avail) of the hand-made cases."""
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = raw.compress(TEXT[:5000]) + raw.flush()
    z = zlib.compress(TEXT[:3000], 9)
    g = _gz(TEXT[:3000])
    cases = {
        "raw, zlib-6": ("deflate", raw, 5000),
        "raw, trailing bytes": ("deflate", raw + b"\x00\xff\x17", 5000),
        "raw, truncated by one": ("deflate", raw[:-1], 5000),
        "raw, truncated to half": ("deflate", raw[:len(raw) // 2], 5000),
        "raw, truncated to one byte": ("deflate", raw[:1], 5000),
        "reserved block type": ("deflate", bytes([0b111, 0, 0]), 10),
        "bad stored NLEN": ("deflate", bytes([1]) + (5).to_bytes(2, "little")
                            + (12345).to_bytes(2, "little") + b"hello", 10),
        "overread": ("deflate", b"\x04", 1 << 20),
        "empty input": ("deflate", b"", 10),
        "zlib-9": ("zlib", z, 3000),
        "zlib, bad Adler-32": ("zlib", z[:-1] + bytes([z[-1] ^ 0xFF]), 3000),
        "zlib, bad header": ("zlib", b"\x78\x9d" + z[2:], 3000),
        "zlib, too short": ("zlib", z[:5], 3000),
        "gzip": ("gzip", g, 3000),
        "gzip, bad CRC-32": ("gzip", g[:-6] + bytes([g[-6] ^ 0xFF]) + g[-5:],
                             3000),
        "gzip, bad ISIZE": ("gzip", g[:-1] + bytes([g[-1] ^ 1]), 3000),
        "gzip, two members": ("gzip", _gz(b"first member ")
                              + _gz(b"and the second"), 100),
        "gzip, too short": ("gzip", g[:17], 3000),
    }
    w = emit.BitWriter()   # literal 'a', then length 3 at offset 4
    _static_block(w, True, [_lit(ord("a")), _lit(257),
                            (int(STATIC_OFFSET_CODES[3]), 5)])
    cases["offset before start"] = ("deflate", w.finish(), 100)
    w = emit.BitWriter()
    for _ in range(5000):
        _static_block(w, False, [])
    _static_block(w, True, [_lit(ord("z"))])
    cases["5001 static blocks"] = ("deflate", w.finish(), 10)
    rng = np.random.default_rng(0x6A5BA6E)
    for k in range(12):
        blob = rng.integers(0, 256, int(rng.integers(1, 50)), np.uint8)
        cases[f"garbage {k}"] = ("deflate", blob.tobytes(), 1 << 16)
    return cases


CRAFTED = _crafted()


def _tuples(pkg, fmt, stream, avail):
    d = pkg.Decompressor()
    return [d.decompress(stream, a, fmt, known) for known in (True, False)
            for a in (avail, avail - 1, avail + 1) if a >= 0]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(CRAFTED))
def test_crafted_tuples_equal(backend, name):
    fmt, stream, avail = CRAFTED[name]
    with on(backend):
        assert _tuples(lt, fmt, stream, avail) == \
            _tuples(ld, fmt, stream, avail)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fmt", hc.FORMATS)
@pytest.mark.parametrize("level", [0, 1, 6, 12])
def test_own_streams_decode_equal(backend, fmt, level):
    for data in (b"", b"q", TEXT[:7000], CORPUS[-9000:]):
        stream = lt.Compressor(level).compress(data, fmt)
        with on(backend):
            got = _tuples(lt, fmt, stream, len(data))
            assert got == _tuples(ld, fmt, stream, len(data))
        assert got[0] == (lt.SUCCESS, data, len(stream), len(data))


def test_gzip_members_in_turn():
    a, b = b"first member ", b"and the second"
    stream = _gz(a) + _gz(b)
    d = lt.Decompressor()
    res, out, ain, _ = d.gzip_decompress(stream, 100)
    assert (res, out) == (lt.SUCCESS, a)
    res, out, ain2, _ = d.gzip_decompress(stream[ain:], 100)
    assert (res, out, ain + ain2) == (lt.SUCCESS, b, len(stream))


@pytest.fixture(scope="module")
def damaged():
    return hc.damaged_set(lt, CORPUS)


@pytest.mark.parametrize("backend", BACKENDS)
def test_damaged_set_equal_and_pinned(backend, damaged):
    pins = json.loads(hc.PINS.read_text())["damaged"][backend]
    with on(backend):
        mine = hc.decode_tuples(lt, damaged)
        assert mine == hc.decode_tuples(ld, damaged)
    assert mine == pins
    results = {row[0] for row in mine}
    assert results == {lt.SUCCESS, lt.BAD_DATA, lt.SHORT_OUTPUT,
                       lt.INSUFFICIENT_SPACE}


def _checksum_inputs():
    rng = np.random.default_rng(0xC5C)
    buf = rng.integers(0, 256, 100003, np.uint8)
    return {"empty": b"", "one byte": b"\xff", "text": TEXT,
            "random": buf.tobytes(), "misaligned view": buf[3:90001],
            "zeros": bytes(70000), "ones": b"\xff" * 5553}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(_checksum_inputs()))
def test_checksums_equal(backend, name):
    data = _checksum_inputs()[name]
    raw = bytes(data)
    with on(backend):
        for init in (None, 0, 1, 0xFFFFFFFF, 0x12345678):
            c = lt.crc32(data) if init is None else lt.crc32(data, init)
            jc = ld.crc32(data) if init is None else ld.crc32(data, init)
            assert c == jc == zlib.crc32(raw, 0 if init is None else init)
            a = lt.adler32(data) if init is None else lt.adler32(data, init)
            ja = ld.adler32(data) if init is None else ld.adler32(data, init)
            if init is None or init & 0xFFFF < 65521 and init >> 16 < 65521:
                # zlib reduces only in-range halves the same way
                assert a == zlib.adler32(raw, 1 if init is None else init)
            assert a == ja
        # chained: the checksum of a||b from a's and then b's
        k = len(raw) // 3
        assert lt.crc32(raw[k:], lt.crc32(raw[:k])) == zlib.crc32(raw)
        assert lt.adler32(raw[k:], lt.adler32(raw[:k])) == zlib.adler32(raw)
        assert lt.crc32_combine(zlib.crc32(raw[:k]), zlib.crc32(raw[k:]),
                                len(raw) - k) == zlib.crc32(raw)
        assert lt.adler32_combine(zlib.adler32(raw[:k]),
                                  zlib.adler32(raw[k:]),
                                  len(raw) - k) == zlib.adler32(raw)
