"""The plain reference and the generator: the gzip check accepts a right
member and rejects a flipped byte, a truncated member and a wrong
trailer; the Python inflater agrees with zlib; the generator's work is
fixed by the mix and its bytes by the seed."""

import gzip
import struct
import zlib

import numpy as np
import pytest

from port_bench import gen
from port_bench.reference import gzip_member
from port_bench.reference.inflate import DataError, inflate

MIX = {"classes": "corpus1", "file_bytes": 8 * 65536, "piece_bytes": 65536,
       "files": 2, "weights": {"text": 2, "skew": 2, "recs": 2, "rand": 1,
                               "runs": 1}}
DATA = gen.make_files(MIX, 2**31 + 11)[0]
CRC = zlib.crc32(DATA)


def member(data=DATA, level=6):
    return gzip.compress(data, compresslevel=level, mtime=0)


def test_a_right_member_passes():
    assert gzip_member.check(member(), DATA, CRC) is None
    assert not gzip_member.over_bound(member(), len(DATA), 65536)


def test_a_flipped_byte_fails():
    m = bytearray(member())
    m[len(m) // 2] ^= 0x20
    assert gzip_member.check(bytes(m), DATA, CRC) is not None


@pytest.mark.parametrize("cut", [1, 8, 9, 200])
def test_a_truncated_member_fails(cut):
    assert gzip_member.check(member()[:-cut], DATA, CRC) is not None


def test_a_wrong_trailer_fails():
    m = member()
    crc, size = struct.unpack("<II", m[-8:])
    assert "CRC-32" in gzip_member.check(
        m[:-8] + struct.pack("<II", crc ^ 1, size), DATA, CRC)
    assert "ISIZE" in gzip_member.check(
        m[:-8] + struct.pack("<II", crc, size + 1), DATA, CRC)
    assert gzip_member.check(m + b"\x00", DATA, CRC) is not None


def test_a_member_of_other_bytes_fails():
    other = DATA[:-1] + bytes([DATA[-1] ^ 1])
    assert "differs" in gzip_member.check(member(other), DATA, CRC)


def test_a_bad_header_fails():
    assert gzip_member.check(b"\x1f\x8b\x07" + member()[3:], DATA,
                             CRC).startswith("header")


def test_the_stored_bound():
    n, chunk = 3 * 65536 + 7, 65536
    assert gzip_member.stored_bound(n, chunk) == 18 + 3 * (
        5 * 2 + 65536 + 5) + (5 + 7 + 5)
    stored = member(DATA, level=0)
    assert not gzip_member.over_bound(stored, len(DATA), 65536)
    assert gzip_member.over_bound(b"x" * (gzip_member.stored_bound(
        len(DATA), 65536) + 1), len(DATA), 65536)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_agrees_with_zlib(level):
    for i in (0, 3, 7):
        chunk = DATA[i * 65536:(i + 1) * 65536]
        assert inflate(gen.raw_deflate(chunk, level)) == chunk


def test_inflate_fixed_blocks_and_overlap():
    data = b"ab" * 300 + b"xyz"
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    assert inflate(c.compress(data) + c.flush()) == data


def test_inflate_rejects_damage():
    s = gen.raw_deflate(DATA[:65536], 6)
    with pytest.raises(DataError):
        inflate(s[:len(s) // 2])
    with pytest.raises(DataError):
        inflate(b"\x07" + s[1:])           # BTYPE 3


def test_the_split_control_changes_only_the_second_half():
    chunk = DATA[:65536]
    got = inflate(gen.raw_deflate(chunk, 6), split=32768)
    assert len(got) == len(chunk) and got != chunk
    assert got[:32768] == chunk[:32768]


def test_the_seed_fixes_the_bytes_and_the_mix_the_work():
    a = gen.make_files(MIX, 5)
    assert a == gen.make_files(MIX, 5)
    b = gen.make_files(MIX, 6)
    assert a[0] != b[0] and a[0] != a[1]
    assert [len(x) for x in a] == [len(x) for x in b] == [8 * 65536] * 2
    # every seed holds the same pieces of each class
    rand = lambda f: sum(  # noqa: E731
        len(zlib.compress(f[i:i + 65536], 1)) > 65536
        for i in range(0, len(f), 65536))
    assert rand(a[0]) == rand(b[0]) == 1


def test_piece_counts():
    assert gen.piece_counts({"a": 2, "b": 2, "c": 1}, 64) == {
        "a": 26, "b": 25, "c": 13}
    assert sum(gen.piece_counts(MIX["weights"], 7).values()) == 7


def test_chunk_streams_are_independent():
    streams = gen.chunk_streams(DATA, 65536, 6, threads=2)
    assert len(streams) == 8
    assert b"".join(zlib.decompress(s, -15) for s in streams) == DATA
    assert np.frombuffer(DATA, np.uint8).size == 8 * 65536
