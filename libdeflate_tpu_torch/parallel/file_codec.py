"""Whole-file chunk-parallel compression over a device mesh.

Counterpart of ``libdeflate_tpu/parallel/file_codec.py``: a file is split
into <= 1 MiB chunks sharded over the mesh (``parallel/mesh.py``), each
chunk becomes a byte-aligned sync-flushed DEFLATE fragment on its
device, the fragments are laid in order into one host buffer (pure byte
concatenation, no bit shifting), and the gzip/zlib trailer is computed
from the per-chunk device checksums by the combine operators.

Per-chunk stored fallback preserves the compress_bound contract on
incompressible chunks, as the reference's cost comparison picks stored
blocks (lib/deflate_compress.c:1779-1814).

The member is laid out from the sizes alone: the gathered total_bits, the
checksums and the chunk lengths come to the host in one sync, each
chunk's slot follows from them (its device bytes, or its stored fragment
where those are longer), and the header, every fragment and the trailer
are written into one buffer of the calling thread, kept across calls and
grown only when a member needs more (pinned memory on a CUDA mesh).  On
a CUDA mesh each kept chunk's bytes are copied straight from the words
into their slot, and nothing else of the words leaves the card.  The
returned ``bytes`` is the one copy of the member.

With a profiler session on, a call's ranges (``utils.profiling.span``)
are ``codec.pad``, the mesh's (``mesh.*``, with the tier entry's
``stage.*`` inside), ``codec.to_host`` (the sizes and checksums, then
the kept chunks' bytes into their slots on a CUDA mesh) with
``codec.grow`` inside it when the buffer is allocated or grown,
``codec.fragments`` (the stored chunks, and the kept chunks' bytes on a
CPU mesh) with one ``codec.stored`` inside it a stored-fallback chunk,
and ``codec.trailer`` (the checksums' combine; the header, the trailer
and the member's copy out of the buffer).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..compress.pipeline import device_stream_to_bytes
from ..formats import gzip_fmt, zlib_fmt
from ..formats.deflate import BLOCKTYPE_UNCOMPRESSED
from ..ops.checksums_host import adler32_combine
from ..ops.crc32_math import crc32_combine_by_table
from ..utils.profiling import span
from . import mesh as mesh_mod

DEFAULT_CHUNK_SIZE = 1 << 20

# each calling thread's assembly buffers, by whether they are pinned: two
# callers on two threads never share one
_assembly = threading.local()


def stored_fragment(chunk, bfinal: bool) -> bytes:
    """Byte-aligned stored-block fragment with trailing sync-flush marker.

    Each block's 3 header bits (BFINAL 0, BTYPE stored) align to one byte,
    so the fragment is written bytewise into one buffer of its final size:
    blocks of at most 65535 bytes, each behind its header byte, LEN and
    NLEN, then an empty stored block carrying BFINAL.  ``chunk`` is any
    bytes-like object (a ``memoryview`` slice is not copied)."""
    n = len(chunk)
    out = bytearray(stored_fragment_size(n))
    src = memoryview(chunk)
    pos = o = 0
    while pos < n:
        seg = min(n - pos, 65535)
        out[o] = BLOCKTYPE_UNCOMPRESSED << 1
        out[o + 1:o + 5] = (seg | (~seg & 0xFFFF) << 16).to_bytes(4, "little")
        out[o + 5:o + 5 + seg] = src[pos:pos + seg]
        pos += seg
        o += 5 + seg
    # sync-flush: empty stored block carrying BFINAL
    out[o] = (1 if bfinal else 0) | BLOCKTYPE_UNCOMPRESSED << 1
    out[o + 1:o + 5] = b"\x00\x00\xff\xff"
    return bytes(out)


def stored_fragment_size(n: int) -> int:
    """``len(stored_fragment(chunk, bfinal))`` for a chunk of ``n`` bytes:
    a block of at most 65535 bytes behind 5 bytes of header each, then
    the 5-byte sync-flush block."""
    return 5 * -(-n // 65535) + n + 5


def _adler_combine_chunks(adlers, lengths, n: int) -> int:
    a = 1
    for i in range(n):
        a = adler32_combine(a, int(adlers[i]), int(lengths[i]))
    return a


def _layout(total_bits: list, sizes: list, start: int):
    """Each chunk's slot in the member, (offset, length, stored), from
    ``start``, and the end of the last one.  A chunk keeps its device
    stream, ``(total_bits + 7) // 8`` bytes, unless its whole bytes are
    more than a stored fragment's: then it takes the stored fragment."""
    slots, off = [], start
    for bits, n in zip(total_bits, sizes):
        # the fallback's test counts one block even for an empty chunk
        stored = bits // 8 > 5 * max(-(-n // 65535), 1) + n + 5
        size = stored_fragment_size(n) if stored else (bits + 7) // 8
        slots.append((off, size, stored))
        off += size
    return slots, off


def _host_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    """The calling thread's uint8 assembly buffer of at least ``nbytes``,
    (re)allocated inside a ``codec.grow`` range only when it is smaller."""
    bufs = _assembly.__dict__.setdefault("bufs", {})
    buf = bufs.get(pinned)
    if buf is None or buf.numel() < nbytes:
        with span("codec.grow"):
            buf = bufs[pinned] = None       # the old one freed first
            buf = bufs[pinned] = torch.empty(nbytes, dtype=torch.uint8,
                                             pin_memory=pinned)
    return buf


def _copy_kept(words: torch.Tensor, slots: list, buf: torch.Tensor) -> None:
    """Each kept chunk's bytes, the first ``length`` of its row of the
    int32 words read as little-endian bytes, into its slot of ``buf``,
    asynchronously from CUDA words, then one wait on the stream that made
    them."""
    rows = words.view(torch.uint8)
    for i, (off, size, stored) in enumerate(slots):
        if not stored:
            buf[off:off + size].copy_(rows[i, :size], non_blocking=True)
    if words.is_cuda:
        torch.cuda.current_stream(words.device).synchronize()


def _gzip_trailer(crc: int, adler: int, isize: int) -> bytes:
    return gzip_fmt.make_trailer(crc, isize)


def _zlib_trailer(crc: int, adler: int, isize: int) -> bytes:
    return zlib_fmt.make_trailer(adler)


# a container: (its header of a level, its trailer's size, its trailer of
# (crc32, adler32, input size))
_GZIP = (gzip_fmt.make_header, gzip_fmt.FOOTER_SIZE, _gzip_trailer)
_ZLIB = (zlib_fmt.make_header, zlib_fmt.FOOTER_SIZE, _zlib_trailer)


def _compress_dp(data: bytes, mesh, chunk_size: int, level: int,
                 frame=None) -> tuple[bytes, int, int]:
    """(member, crc32, adler32): the chunk-parallel raw DEFLATE stream,
    inside ``frame``'s header and trailer when one (``_GZIP``, ``_ZLIB``)
    is given."""
    if mesh is None:
        mesh = mesh_mod.make_chunk_mesh()
    head = frame[0](level) if frame else b""
    tail = frame[1] if frame else 0

    if len(data) == 0:
        stream = stored_fragment(b"", True)
        if frame is None:
            return stream, 0, 1
        with span("codec.trailer"):
            return head + stream + frame[2](0, 1, 0), 0, 1

    with span("codec.pad"):
        bufs, lengths, bfinal, nchunks = mesh_mod.pad_chunks(
            data, chunk_size, len(mesh.devices))
    words, _, crcs, adlers, all_bits = mesh_mod.compress_chunks_dp(
        mesh, bufs, lengths, bfinal, level=level
    )
    sizes = lengths[:nchunks].tolist()
    with span("codec.to_host"):
        # the one sync: the gathered sizes (the global byte layout) and
        # the checksums
        total_bits, crcs, adlers = torch.stack(
            [all_bits, crcs, adlers])[:, :nchunks].tolist()
        slots, end = _layout(total_bits, sizes, len(head))
        on_card = words.is_cuda
        buf = _host_buffer(end + tail, on_card)
        if on_card:
            _copy_kept(words, slots, buf)
        else:
            words = words.numpy()
        out = buf.numpy()

    with span("codec.fragments"):
        view = memoryview(data)
        for i, (off, size, stored) in enumerate(slots):
            if stored:
                with span("codec.stored"):
                    frag = stored_fragment(
                        view[i * chunk_size: i * chunk_size + sizes[i]],
                        bool(bfinal[i]))
            elif not on_card:
                # host words: the per-chunk conversion, which the
                # benchmark's fault checks alter on a CPU mesh
                frag = device_stream_to_bytes(words[i], total_bits[i])
            else:
                continue
            out[off:off + size] = np.frombuffer(frag, np.uint8)

    with span("codec.trailer"):
        crc = 0
        for c, n in zip(crcs, sizes):
            crc = crc32_combine_by_table(crc, c, n)
        adler = _adler_combine_chunks(adlers, sizes, nchunks)
        if frame is None:
            return out[:end].tobytes(), crc, adler
    with span("codec.trailer"):
        out[:len(head)] = np.frombuffer(head, np.uint8)
        out[end:end + tail] = np.frombuffer(frame[2](crc, adler, len(data)),
                                            np.uint8)
        return out[:end + tail].tobytes(), crc, adler


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
    return _compress_dp(data, mesh, chunk_size, level)


def gzip_compress_dp(data: bytes, mesh: mesh_mod.ChunkMesh | None = None,
                     chunk_size: int = DEFAULT_CHUNK_SIZE,
                     level: int = 1) -> bytes:
    return _compress_dp(data, mesh, chunk_size, level, _GZIP)[0]


def zlib_compress_dp(data: bytes, mesh: mesh_mod.ChunkMesh | None = None,
                     chunk_size: int = DEFAULT_CHUNK_SIZE,
                     level: int = 1) -> bytes:
    return _compress_dp(data, mesh, chunk_size, level, _ZLIB)[0]
