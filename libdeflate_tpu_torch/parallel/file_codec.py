"""Whole-file chunk-parallel compression over a device mesh.

Counterpart of ``libdeflate_tpu/parallel/file_codec.py``: a file is split
into <= 1 MiB chunks sharded over the mesh (``parallel/mesh.py``), each
chunk becomes a byte-aligned sync-flushed DEFLATE fragment on its
device, the fragments are joined in order on the host (pure byte
concatenation, no bit shifting), and the gzip/zlib trailer is computed
from the per-chunk device checksums by the combine operators.

Per-chunk stored fallback preserves the compress_bound contract on
incompressible chunks, as the reference's cost comparison picks stored
blocks (lib/deflate_compress.c:1779-1814).

With a profiler session on, a call's ranges (``utils.profiling.span``)
are ``codec.pad``, the mesh's (``mesh.*``, with the tier entry's
``stage.*`` inside), ``codec.to_host`` (the words, sizes and checksums to
the host), ``codec.fragments`` (the per-chunk bytes and the join) with
one ``codec.stored`` inside it a stored-fallback chunk, and
``codec.trailer`` (the checksums' combine; the header and trailer).
"""

from __future__ import annotations

from ..compress.emit import BitWriter
from ..compress.pipeline import device_stream_to_bytes
from ..formats import gzip_fmt, zlib_fmt
from ..formats.deflate import BLOCKTYPE_UNCOMPRESSED
from ..ops.checksums_host import adler32_combine
from ..ops.crc32_math import crc32_combine
from ..utils.profiling import span
from . import mesh as mesh_mod

DEFAULT_CHUNK_SIZE = 1 << 20


def stored_fragment(chunk: bytes, bfinal: bool) -> bytes:
    """Byte-aligned stored-block fragment with trailing sync-flush marker."""
    w = BitWriter()
    pos = 0
    n = len(chunk)
    while pos < n:
        seg = min(n - pos, 65535)
        w.add(0, 1)
        w.add(BLOCKTYPE_UNCOMPRESSED, 2)
        w.align_to_byte()
        w.out += seg.to_bytes(2, "little")
        w.out += (~seg & 0xFFFF).to_bytes(2, "little")
        w.out += chunk[pos : pos + seg]
        pos += seg
    # sync-flush: empty stored block carrying BFINAL
    w.add(1 if bfinal else 0, 1)
    w.add(BLOCKTYPE_UNCOMPRESSED, 2)
    w.align_to_byte()
    w.out += b"\x00\x00\xff\xff"
    return w.finish()


def _adler_combine_chunks(adlers, lengths, n: int) -> int:
    a = 1
    for i in range(n):
        a = adler32_combine(a, int(adlers[i]), int(lengths[i]))
    return a


def deflate_compress_dp(
    data: bytes,
    mesh: mesh_mod.ChunkMesh | None = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    level: int = 1,
) -> tuple[bytes, int, int]:
    """Chunk-parallel raw DEFLATE.  Returns (stream, crc32, adler32).

    ``level`` picks the chunk compressor (``mesh.chunk_compressor``).  The
    checksums of the *uncompressed* data come along from the device pass,
    pre-combined for wrapper trailers.  ``mesh=None`` is every CUDA
    device (``make_chunk_mesh()``), its shards run at once."""
    if mesh is None:
        mesh = mesh_mod.make_chunk_mesh()
    ndev = len(mesh.devices)

    if len(data) == 0:
        return stored_fragment(b"", True), 0, 1

    with span("codec.pad"):
        bufs, lengths, bfinal, nchunks = mesh_mod.pad_chunks(
            data, chunk_size, ndev)
    words, _, crcs, adlers, all_bits = mesh_mod.compress_chunks_dp(
        mesh, bufs, lengths, bfinal, level=level
    )
    with span("codec.to_host"):
        words = words.cpu().numpy()
        # the gathered sizes are the global byte layout; assemble from them
        total_bits = all_bits.tolist()
        crcs = crcs.tolist()
        adlers = adlers.tolist()

    with span("codec.fragments"):
        parts = []
        for i in range(nchunks):
            dev_bytes = int(total_bits[i]) // 8
            chunk = data[i * chunk_size : i * chunk_size + int(lengths[i])]
            stored_size = 5 * max(-(-len(chunk) // 65535), 1) + len(chunk) + 5
            if dev_bytes <= stored_size:
                parts.append(device_stream_to_bytes(words[i], total_bits[i]))
            else:
                with span("codec.stored"):
                    parts.append(stored_fragment(chunk, bool(bfinal[i])))
        stream = b"".join(parts)

    with span("codec.trailer"):
        crc = 0
        for i in range(nchunks):
            crc = crc32_combine(crc, int(crcs[i]), int(lengths[i]))
        adler = _adler_combine_chunks(adlers, lengths, nchunks)
    return stream, crc, adler


def gzip_compress_dp(data: bytes, mesh: mesh_mod.ChunkMesh | None = None,
                     chunk_size: int = DEFAULT_CHUNK_SIZE,
                     level: int = 1) -> bytes:
    stream, crc, _ = deflate_compress_dp(data, mesh, chunk_size, level)
    with span("codec.trailer"):
        return (
            gzip_fmt.make_header(level)
            + stream
            + gzip_fmt.make_trailer(crc, len(data))
        )


def zlib_compress_dp(data: bytes, mesh: mesh_mod.ChunkMesh | None = None,
                     chunk_size: int = DEFAULT_CHUNK_SIZE,
                     level: int = 1) -> bytes:
    stream, _, adler = deflate_compress_dp(data, mesh, chunk_size, level)
    with span("codec.trailer"):
        return (
            zlib_fmt.make_header(level)
            + stream
            + zlib_fmt.make_trailer(adler)
        )
