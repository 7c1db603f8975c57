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

The file goes to the devices from one batch buffer of the calling
thread, kept across calls (pinned memory on a CUDA mesh): the file in
one copy, the last chunk's tail and the mesh's padding rows zeroed, each
shard's rows to its device without blocking (``mesh.compress_shards``).
The shards' results stay on their own devices: nothing is gathered.

The member is laid out from the sizes alone: each shard's total_bits and
checksums come to the host in one sync a shard, each chunk's slot
follows from them and the chunk lengths (its device bytes, or its stored
fragment where those are longer), and the header, every fragment and the
trailer are written into a second buffer of the calling thread, kept
across calls and grown only when a member needs more (pinned on a CUDA
mesh).  On a CUDA mesh each kept chunk's bytes are copied straight from
its card's words into their slot, every card's copies issued before any
card is waited on, and nothing else of the words leaves the cards.  The
returned ``bytes`` is the one copy of the member.

With a profiler session on, a call's ranges (``utils.profiling.span``)
are ``codec.pad`` (with ``codec.grow`` inside it when the batch buffer
is allocated or grown), the mesh's (``mesh.*``, one ``mesh.card_in`` a
shard, the tier entry's ``stage.*`` inside), ``codec.to_host`` (the
sizes and checksums, then one ``mesh.card_out`` a shard: on a CUDA mesh
its kept chunks' bytes into their slots and the wait on them, on a CPU
mesh its words handed to the host) with ``codec.grow`` inside it when
the member buffer is allocated or grown, ``codec.fragments`` (the stored
chunks, and the kept chunks' bytes on a CPU mesh) with one
``codec.stored`` inside it a stored-fallback chunk, and
``codec.trailer`` (the checksums' combine; the header, the trailer and
the member's copy out of the buffer).
"""

from __future__ import annotations

import contextlib
import functools
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

# each calling thread's buffers, by whether they are pinned: the members'
# (``bufs``) and the batches' (``batch``); two callers on two threads
# never share one
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


def _thread_buffer(kind: str, nbytes: int, pinned: bool) -> torch.Tensor:
    """The calling thread's uint8 buffer of ``kind`` ("bufs", the member;
    "batch", the padded chunks on their way to the devices) of at least
    ``nbytes``, (re)allocated inside a ``codec.grow`` range only when it
    is smaller."""
    bufs = _assembly.__dict__.setdefault(kind, {})
    buf = bufs.get(pinned)
    if buf is None or buf.numel() < nbytes:
        with span("codec.grow"):
            buf = bufs[pinned] = None       # the old one freed first
            buf = bufs[pinned] = torch.empty(nbytes, dtype=torch.uint8,
                                             pin_memory=pinned)
    return buf


def _host_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    """The calling thread's member buffer (``_thread_buffer``)."""
    return _thread_buffer("bufs", nbytes, pinned)


def _copy_kept(words: torch.Tensor, slots: list, buf: torch.Tensor) -> None:
    """Each kept chunk's bytes, the first ``length`` of its row of the
    int32 words read as little-endian bytes, into its slot of ``buf``
    (``slots`` one a row, from the first; rows past them are padding),
    asynchronously from CUDA words on their device's current stream,
    which the caller waits on."""
    rows = words.view(torch.uint8)
    for i, (off, size, stored) in enumerate(slots):
        if not stored:
            buf[off:off + size].copy_(rows[i, :size], non_blocking=True)


def _copy_out(shards: list, slots: list, buf: torch.Tensor) -> None:
    """Every shard's kept chunks into their slots of ``buf``, each from its
    own device: all the shards' copies issued before any device is waited
    on.  One ``mesh.card_out`` range a shard covers its copies and its
    wait; the ranges nest, so the last shard's is innermost and each
    wait falls in its own shard's range."""
    per = shards[0][0].shape[0]
    with contextlib.ExitStack() as waits:
        for k, (words, *_) in enumerate(shards):
            waits.enter_context(span("mesh.card_out"))
            _copy_kept(words, slots[k * per:(k + 1) * per], buf)
            if words.is_cuda:
                waits.callback(
                    torch.cuda.current_stream(words.device).synchronize)


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

    on_card = any(dev.type == "cuda" for dev in mesh.devices)
    with span("codec.pad"):
        bufs, lengths, bfinal, nchunks = mesh_mod.pad_chunks(
            data, chunk_size, len(mesh.devices),
            functools.partial(_thread_buffer, "batch", pinned=on_card))
    try:
        shards = mesh_mod.compress_shards(mesh, bufs, lengths, bfinal,
                                          level=level)
    except BaseException:
        # the copies may still read the batch buffer, which this thread's
        # next call rewrites
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        raise
    sizes = lengths[:nchunks].tolist()
    with span("codec.to_host"):
        # one sync a shard: its sizes (the global byte layout) and its
        # checksums, on its own device
        per_shard = [torch.stack(s[1:]).tolist() for s in shards]
        total_bits, crcs, adlers = (
            [v for rows in per_shard for v in rows[j]][:nchunks]
            for j in range(3))
        slots, end = _layout(total_bits, sizes, len(head))
        buf = _host_buffer(end + tail, on_card)
        if on_card:
            _copy_out(shards, slots, buf)
        else:
            words = []
            for s in shards:
                with span("mesh.card_out"):     # a CPU shard's words as is
                    words.append(s[0].numpy())
            words = np.concatenate(words)
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
