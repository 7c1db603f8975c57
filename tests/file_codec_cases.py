"""Shared cases of the whole-file codec tests (test_torch_file_codec*.py).

The port's ``parallel/file_codec.py`` and ``parallel/mesh.py`` on a mesh
of eight CPU devices against the JAX package's on the forced 8-device
CPU mesh (tests/conftest.py), on the inputs of
``tests/test_parallel.py::TestChunkDP`` cut to at most 8 chunks of
16 KiB: every JAX call then has B = 8 and one chunk shape, so each level
compiles once a file.  Tolerance: exact.
"""

import functools
import zlib
from pathlib import Path

import numpy as np

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from dp_tier_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu.compress.tpu_pipeline import device_stream_to_bytes
from libdeflate_tpu.parallel import file_codec as jfc
from libdeflate_tpu.parallel import mesh as jm
from libdeflate_tpu_torch.parallel import mesh as pm

REPO = Path(__file__).resolve().parents[1]
CS = 16 * 1024
TEXT = (REPO / "SURVEY.md").read_bytes() * 3


@functools.lru_cache(maxsize=None)
def meshes():
    """(JAX 8-device CPU mesh, port mesh of 8 CPU devices)."""
    import jax

    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jm.make_chunk_mesh(), lt.make_chunk_mesh(["cpu"] * 8)


def _rand(seed: int, n: int, lo: int = 0, hi: int = 256) -> bytes:
    return np.random.default_rng(seed).integers(lo, hi, n,
                                                dtype=np.uint8).tobytes()


# name -> input bytes, each at most 8 chunks of CS
CASES = {
    "survey text": TEXT[: 8 * CS - 1000],
    "skewed alphabet": _rand(1, 120000, 97, 110),
    "random bytes": _rand(2, 120000),
    "empty": b"",
    "1 byte": b"x",
    "6 bytes": b"ab" * 3,
    **{f"{n} bytes at the chunk boundary": _rand(n, n, 97, 105)
       for n in (CS - 1, CS, CS + 1, 7 * CS + 1, 8 * CS)},
}
# the cases whose (stream, crc32, adler32) is also checked on its own
DEFLATE_CASES = ("survey text", "random bytes", "empty",
                 f"{8 * CS} bytes at the chunk boundary")


def check_file_codec(case: str, level: int) -> None:
    """gzip and zlib bytes (and, for DEFLATE_CASES, the raw stream, CRC-32
    and Adler-32) equal the JAX package's; each inflates through zlib."""
    data = CASES[case]
    jmesh, pmesh = meshes()
    for name in ("gzip_compress_dp", "zlib_compress_dp"):
        got = getattr(lt, name)(data, pmesh, chunk_size=CS, level=level)
        want = getattr(jfc, name)(data, jmesh, chunk_size=CS, level=level)
        assert got == want, (name, case, level)
        assert zlib.decompress(got, 31 if name[0] == "g" else 15) == data
    if case not in DEFLATE_CASES:
        return
    stream, crc, adler = lt.deflate_compress_dp(data, pmesh, CS, level)
    assert (stream, crc, adler) == jfc.deflate_compress_dp(data, jmesh, CS,
                                                           level)
    assert zlib.decompress(stream, -15) == data
    assert (crc, adler) == (zlib.crc32(data), zlib.adler32(data))
    # the bound contract: the stored fallback keeps the stream under the
    # bound plus one sync marker a chunk
    nchunks = max(-(-len(data) // CS), 1)
    assert len(stream) <= ld.deflate_compress_bound(len(data)) + 5 * nchunks


def dp_batch():
    """A B = 8 batch of 16 KiB chunks: text, skewed, random, records, a
    short chunk, an empty one and two more text chunks; BFINAL mixed."""
    text = TEXT
    rows = [text[:CS], CASES["skewed alphabet"][:CS],
            CASES["random bytes"][:CS],
            np.tile(np.frombuffer(_rand(3, 64), np.uint8),
                    CS // 64).tobytes(),
            text[CS:2 * CS], b"", text[2 * CS:3 * CS], text[3 * CS:4 * CS]]
    bufs = np.zeros((8, CS), np.uint8)
    lengths = np.array([CS, CS, CS, CS, 3000, 0, CS, 40000 % CS], np.int32)
    for i, r in enumerate(rows):
        bufs[i, : len(r)] = np.frombuffer(r, np.uint8)
    bfinal = np.array([0, 1, 0, 0, 1, 1, 0, 1], bool)
    return bufs, lengths, bfinal


def check_compress_chunks_dp(level: int) -> None:
    """All five outputs of compress_chunks_dp equal the JAX mesh's: words
    as each chunk's stream up to its total_bits."""
    jmesh, pmesh = meshes()
    bufs, lengths, bfinal = dp_batch()
    got = pm.compress_chunks_dp(pmesh, bufs, lengths, bfinal, level=level)
    want = [np.asarray(x) for x in jm.compress_chunks_dp(
        jmesh, bufs, lengths, bfinal, level=level)]
    words, total_bits, crcs, adlers, all_bits = got
    for k, name in ((1, "total_bits"), (2, "crcs"), (3, "adlers"),
                    (4, "all_bits")):
        assert got[k].tolist() == want[k].astype(np.int64).tolist(), name
    for i in range(len(bufs)):
        stream = lt.device_stream_to_bytes(words[i], total_bits[i])
        assert stream == device_stream_to_bytes(want[0][i], want[1][i]), i
        d = zlib.decompressobj(-15)
        assert d.decompress(stream) == bufs[i, : lengths[i]].tobytes()
        assert d.eof == bool(bfinal[i])
