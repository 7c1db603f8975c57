"""The whole-file member's layout (``parallel/file_codec.py``) against the
per-chunk assembly it replaced, kept here as the plain reference.

``deflate_compress_dp``, ``gzip_compress_dp`` and ``zlib_compress_dp`` on
one- and eight-device CPU meshes at levels 0, 1 and 6, on the cases of
tests/file_codec_cases.py (an empty file, single short chunks, short last
chunks, every chunk stored, none stored): bytes and checksums equal the
reference's.  The chunk compressor's outputs are the mesh's own, made
once a case and level on one device and handed to both sides (a chunk's
bits do not depend on the mesh's size: tests/test_torch_mesh.py), so the
comparison is of the assembly alone; tests/test_torch_file_codec*.py hold
the whole path to the JAX package.  Also: the thread's buffer grows only
for a larger member and is reused, no two threads share one, the kept
chunks' byte copy equals the per-chunk conversion, and the stored
fragment's closed-form length.  Tolerance: exact.
"""

import functools
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from file_codec_cases import CASES, CS, one_torch_thread  # noqa: F401
from libdeflate_tpu_torch.compress.pipeline import device_stream_to_bytes
from libdeflate_tpu_torch.formats import gzip_fmt, zlib_fmt
from libdeflate_tpu_torch.ops.crc32_math import crc32_combine
from libdeflate_tpu_torch.parallel import file_codec
from libdeflate_tpu_torch.parallel import mesh as pm

LEVELS = (0, 1, 6)
NDEV = (1, 8)
COMPRESS_SHARDS = pm.compress_shards     # the mesh's, unpatched


def reference_deflate(data, mesh, chunk_size, level):
    """The per-chunk assembly the layout replaced: every chunk's words to
    bytes, the stored fallback, one join, the combines chunk by chunk."""
    if len(data) == 0:
        return file_codec.stored_fragment(b"", True), 0, 1
    bufs, lengths, bfinal, nchunks = pm.pad_chunks(data, chunk_size,
                                                   len(mesh.devices))
    words, _, crcs, adlers, all_bits = pm.compress_chunks_dp(
        mesh, bufs, lengths, bfinal, level=level)
    words = words.cpu().numpy()
    total_bits, crcs, adlers = (all_bits.tolist(), crcs.tolist(),
                                adlers.tolist())
    parts = []
    for i in range(nchunks):
        dev_bytes = int(total_bits[i]) // 8
        chunk = data[i * chunk_size: i * chunk_size + int(lengths[i])]
        stored_size = 5 * max(-(-len(chunk) // 65535), 1) + len(chunk) + 5
        if dev_bytes <= stored_size:
            parts.append(device_stream_to_bytes(words[i], total_bits[i]))
        else:
            parts.append(file_codec.stored_fragment(chunk, bool(bfinal[i])))
    crc = 0
    for i in range(nchunks):
        crc = crc32_combine(crc, int(crcs[i]), int(lengths[i]))
    adler = file_codec._adler_combine_chunks(adlers, lengths, nchunks)
    return b"".join(parts), crc, adler


def reference(name, data, mesh, level):
    stream, crc, adler = reference_deflate(data, mesh, CS, level)
    if name == "deflate_compress_dp":
        return stream, crc, adler
    if name == "gzip_compress_dp":
        return (gzip_fmt.make_header(level) + stream
                + gzip_fmt.make_trailer(crc, len(data)))
    return zlib_fmt.make_header(level) + stream + zlib_fmt.make_trailer(adler)


@functools.lru_cache(maxsize=None)
def _outputs(data: bytes, level: int):
    """compress_chunks_dp's five outputs for ``data`` padded to 8 chunks,
    on one CPU device."""
    bufs, lengths, bfinal, _ = pm.pad_chunks(data, CS, 8)
    (outs,) = COMPRESS_SHARDS(pm.make_chunk_mesh(["cpu"]), bufs, lengths,
                              bfinal, level=level)
    return bufs, (*outs, outs[1].clone())


@pytest.fixture
def replay(monkeypatch):
    """``pm.compress_chunks_dp`` and the codec's ``pm.compress_shards``
    answered from ``_outputs``: the rows of the call's batch (its chunks,
    then the mesh's empty padding), gathered or split into the mesh's
    shards."""
    def replayed(mesh, bufs, lengths, bfinal, level=1):
        bufs = np.asarray(bufs)
        data = bufs.reshape(-1)[: int(np.sum(lengths))].tobytes()
        want_bufs, outs = _outputs(data, level)
        b = len(bufs)
        assert b <= len(want_bufs) and np.array_equal(bufs, want_bufs[:b])
        return [t[:b].clone() for t in outs]

    def shards(mesh, bufs, lengths, bfinal, level=1):
        outs = replayed(mesh, bufs, lengths, bfinal, level)[:4]
        per = len(bufs) // len(mesh.devices)
        return [tuple(t[k * per:(k + 1) * per] for t in outs)
                for k in range(len(mesh.devices))]
    monkeypatch.setattr(pm, "compress_chunks_dp", replayed)
    monkeypatch.setattr(pm, "compress_shards", shards)


@pytest.fixture
def fresh_buffers(monkeypatch):
    """The calling thread starts with no assembly buffer."""
    monkeypatch.setattr(file_codec, "_assembly", threading.local())


def _buffer():
    return file_codec._assembly.bufs[False]


@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("case", CASES)
def test_member_equals_the_per_chunk_assembly(case, level, ndev, replay):
    data = CASES[case]
    mesh = pm.make_chunk_mesh(["cpu"] * ndev)
    for name in ("deflate_compress_dp", "gzip_compress_dp",
                 "zlib_compress_dp"):
        got = getattr(file_codec, name)(data, mesh, CS, level)
        assert got == reference(name, data, mesh, level), name
    stream, crc, adler = got_raw = file_codec.deflate_compress_dp(
        data, mesh, CS, level)
    assert zlib.decompress(stream, -15) == data
    assert got_raw[1:] == (zlib.crc32(data), zlib.adler32(data))


@pytest.mark.parametrize("level", LEVELS)
def test_the_cases_hold_every_kind_of_slot(level):
    """Every chunk stored in one case, none in another, and a short last
    chunk after kept ones in a third."""
    def kinds(case):
        data = CASES[case]
        _, outs = _outputs(data, level)
        n = -(-len(data) // CS)
        sizes = [min(CS, len(data) - i * CS) for i in range(n)]
        slots, _ = file_codec._layout(outs[4][:n].tolist(), sizes, 0)
        return [stored for _, _, stored in slots], sizes

    stored, _ = kinds("random bytes")
    assert len(stored) == 8 and all(stored)
    stored, _ = kinds("survey text")
    assert len(stored) == 8 and not any(stored)
    stored, sizes = kinds(f"{7 * CS + 1} bytes at the chunk boundary")
    assert sizes[-1] == 1 and not any(stored)


@pytest.mark.parametrize("ndev", NDEV)
def test_the_buffer_grows_only_for_a_larger_member(ndev, replay,
                                                   fresh_buffers,
                                                   monkeypatch):
    mesh = pm.make_chunk_mesh(["cpu"] * ndev)
    small, large = CASES["survey text"][:3 * CS], CASES["random bytes"]
    grown = []
    real = file_codec._host_buffer

    def noted(nbytes, pinned):
        before = file_codec._assembly.__dict__.get("bufs", {}).get(pinned)
        buf = real(nbytes, pinned)
        grown.append(buf is not before)
        return buf
    monkeypatch.setattr(file_codec, "_host_buffer", noted)
    for data in (small, small, large, small, large):
        got = file_codec.gzip_compress_dp(data, mesh, CS, 1)
        assert got == reference("gzip_compress_dp", data, mesh, 1)
    assert grown == [True, False, True, False, False]
    assert _buffer().numel() == len(got)


def test_no_two_threads_share_a_buffer(replay):
    """Eight threads at once, each compressing the files in its own order
    with a short switch interval: every member is the reference's, and
    the threads' buffers, read while all of them are alive, are eight."""
    mesh = pm.make_chunk_mesh(["cpu"])
    files = [CASES["survey text"][: (k + 1) * CS // 2] for k in range(8)]
    want = [reference("zlib_compress_dp", f, mesh, 0) for f in files]
    got, held = {}, {}
    barrier = threading.Barrier(8, timeout=60)

    def work(k):
        barrier.wait()
        for r in range(4):
            j = (k + r) % 8
            got[k, r] = file_codec.zlib_compress_dp(files[j], mesh, CS, 0)
        held[k] = _buffer().data_ptr()
        barrier.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(got[k, r] == want[(k + r) % 8] for k in range(8)
               for r in range(4))
    assert len(set(held.values())) == 8


@pytest.mark.parametrize("level", LEVELS)
def test_kept_bytes_copy_equals_the_per_chunk_conversion(level):
    """``_copy_kept`` (the card's path, here on CPU tensors) lays each kept
    chunk's row bytes where the per-chunk conversion puts them, and
    writes nothing into a stored chunk's slot."""
    data = CASES["survey text"][: 5 * CS] + CASES["random bytes"][:CS + 7]
    _, outs = _outputs(data, level)
    words, total_bits = outs[0], outs[4].tolist()
    n = 7
    sizes = [min(CS, len(data) - i * CS) for i in range(n)]
    slots, end = file_codec._layout(total_bits[:n], sizes, 10)
    assert [s for _, _, s in slots] == [False] * 5 + [True, False]
    buf = torch.full((end + 3,), 0xA5, dtype=torch.uint8)
    file_codec._copy_kept(words, slots, buf)
    out = buf.numpy().tobytes()
    for i, (off, size, stored) in enumerate(slots):
        if stored:
            assert out[off:off + size] == b"\xa5" * size
        else:
            want = device_stream_to_bytes(words[i], total_bits[i])
            assert out[off:off + size] == want and len(want) == size
    assert out[:10] == b"\xa5" * 10 and out[end:] == b"\xa5" * 3


@pytest.mark.parametrize("n", [0, 1, 65534, 65535, 65536, 2 * 65535,
                               2 * 65535 + 1, CS, 1 << 20])
def test_stored_fragment_size_is_its_length(n):
    chunk = bytes(range(256)) * (n // 256) + bytes(n % 256)
    for bfinal in (False, True):
        assert len(file_codec.stored_fragment(chunk, bfinal)) == \
            file_codec.stored_fragment_size(n)
