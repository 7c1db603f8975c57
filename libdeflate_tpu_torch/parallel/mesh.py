"""Chunk data parallelism over a list of devices.

Counterpart of ``libdeflate_tpu/parallel/mesh.py``.  The JAX mesh is one
program over every device: ``shard_map`` runs the chunk compressor on
each device's contiguous shard of the batch and ``all_gather`` hands
every shard the per-chunk sizes.  Here one host thread drives the same
split over a ``ChunkMesh``, a tuple of ``torch.device``:

- each shard runs the chunk compressor of its level on its own device,
  as one batched call (the JAX shard's ``vmap``), and the per-chunk
  device checksums beside it (``ops/checksums.py``);
- the gather is the shards' sizes concatenated, in shard order, into
  one ``[B]`` tensor: the global byte layout that the whole-file
  assembly (``parallel/file_codec.py``) reads.

The shards run in turn, so more cards would only cut the batch into
smaller host-paced calls: the default mesh is the current CUDA device,
and a caller who wants several names them.  Chunk streams are
byte-aligned sync-flushed DEFLATE fragments, so ordered assembly is
concatenation, and every chunk's bits are independent of the mesh's
size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..compress.dynamic import compress_chunks_dynamic
from ..compress.optimal import MESH_LEVEL_OPTIONS, compress_chunks_optimal_with
from ..compress.pipeline import compress_chunks_static
from ..decompress import decode, fsm
from ..device import as_tensor, from_numpy_batch, resolve_device
from ..ops.checksums import adler32_chunks, crc32_chunks


@dataclass(frozen=True)
class ChunkMesh:
    """The devices a batch of chunks is split over, in shard order."""

    devices: tuple[torch.device, ...]


def make_chunk_mesh(devices=None) -> ChunkMesh:
    """A mesh over ``devices`` (names or ``torch.device``s; repeats are
    separate shards, so ``["cpu"] * 8`` is an 8-device CPU mesh), by
    default the current CUDA device alone.  Without CUDA the default
    raises: the mesh never falls back to the CPU."""
    if devices is None:
        resolve_device()
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a chunk mesh needs at least one device")
    return ChunkMesh(devices)


def chunk_compressor(level: int):
    """The chunk compressor of a level, the ladder of
    ``_chunk_compressor`` (``mesh.py:41-82``): 0 and below the static
    tier; 1-4 dynamic Huffman (dyn1); 5-7 the lean single-cost-pass DP;
    8-9 the DP with two cost passes and the full candidate pool; 10 and
    above the deep candidates and len-3 matches.  Each takes (bufs,
    lengths, bfinal, device=...)."""
    if level <= 0:
        return compress_chunks_static
    for floor in (10, 8, 5):
        if level >= floor:
            return functools.partial(compress_chunks_optimal_with,
                                     **MESH_LEVEL_OPTIONS[floor])
    return compress_chunks_dynamic


def _shards(mesh: ChunkMesh, batch: int):
    """(device, slice of the batch) for each shard, as ``P(axis, None)``
    splits it: contiguous, in order, equal."""
    n = len(mesh.devices)
    if batch % n:
        raise ValueError(f"the batch ({batch} chunks) must be a multiple of "
                         f"the mesh size ({n}); pad with empty chunks")
    per = batch // n
    return [(dev, slice(k * per, (k + 1) * per))
            for k, dev in enumerate(mesh.devices)]


def _gather(parts, lead: torch.device) -> torch.Tensor:
    """The shards' results, in shard order, as one tensor on ``lead``."""
    return torch.cat([p.to(lead) for p in parts])


def compress_chunks_dp(mesh: ChunkMesh, bufs, lengths, bfinal,
                       level: int = 1):
    """Compress [B, N] chunks data-parallel over the mesh.

    B must be a multiple of the mesh size (pad with empty chunks).
    Returns (words int32[B, W] holding the uint32 bit patterns,
    total_bits [B], crcs [B], adlers [B], all_bits [B]), on the mesh's
    first device."""
    compress = chunk_compressor(level)
    bufs = as_tensor(bufs, np.uint8)
    lengths = as_tensor(lengths, np.int64)
    bfinal = as_tensor(bfinal, bool)
    outs = []
    for dev, part in _shards(mesh, bufs.shape[0]):
        b, n, f = from_numpy_batch(bufs[part], lengths[part], bfinal[part],
                                   dev)
        words, total_bits = compress(b, n, f, device=dev)
        outs.append((words, total_bits, crc32_chunks(b, n, device=dev),
                     adler32_chunks(b, n, device=dev)))
    lead = mesh.devices[0]
    words, total_bits, crcs, adlers = (_gather(list(col), lead)
                                       for col in zip(*outs))
    return words, total_bits, crcs, adlers, total_bits.clone()


def resolve_decoder(decoder: str, devices) -> str:
    """The decoder that ``decompress_chunks_dp`` runs on a mesh of
    ``devices``: "fsm" (``decompress/fsm.py``, F1 on CUDA) or "pallas"
    (``decompress/decode.py``, K3 on CUDA).  "auto" follows the JAX mesh
    (``mesh.py:159-161``), which takes its scalar Pallas decoder on a TPU
    and the FSM decoder elsewhere: here "pallas" when the first device is
    CUDA, where K3 is the card's hand-written decoder as the Pallas
    kernel is the TPU's, and "fsm" on CPU devices, which gives what the
    JAX "auto" gives on a CPU mesh."""
    if decoder == "auto":
        return ("pallas" if torch.device(devices[0]).type == "cuda"
                else "fsm")
    if decoder not in ("fsm", "pallas"):
        raise ValueError(f"unknown decoder {decoder!r}")
    return decoder


def decompress_chunks_dp(mesh: ChunkMesh, bufs, in_lens, out_lens,
                         out_cap: int, decoder: str = "auto"):
    """Decompress [B, N] raw-DEFLATE chunk fragments data-parallel over
    the mesh (the decode direction of ``compress_chunks_dp``; every chunk
    an independent stream).

    ``decoder`` "fsm", "pallas" or "auto" (``resolve_decoder``: K3 on a
    CUDA mesh, the FSM decoder on CPU devices).  Each shard runs the
    decoder's ``decompress_chunks`` on its device (the kernel on CUDA,
    the plain version on the CPU).  Known-size contract at the mesh
    layer: a chunk that decodes (status 0) to other than its
    ``out_lens`` is BAD_DATA (1).  Returns (out uint8[B, out_cap],
    out_lens [B], consumed [B], status [B], all_lens [B]) on the mesh's
    first device."""
    decode_fn = {"fsm": fsm.decompress_chunks,
                 "pallas": decode.decompress_chunks}[
        resolve_decoder(decoder, mesh.devices)]
    bufs = as_tensor(bufs, np.uint8)
    in_lens = as_tensor(in_lens, np.int32)
    out_lens = as_tensor(out_lens, np.int32)
    outs = []
    for dev, part in _shards(mesh, bufs.shape[0]):
        out, oplens, consumed, status = decode_fn(
            bufs[part], in_lens[part], out_cap, device=dev)
        want = out_lens[part].to(dev, oplens.dtype)
        status = torch.where((status == 0) & (oplens != want),
                             torch.ones_like(status), status)
        outs.append((out, oplens, consumed, status))
    lead = mesh.devices[0]
    out, oplens, consumed, status = (_gather(list(col), lead)
                                     for col in zip(*outs))
    return out, oplens, consumed, status, oplens.clone()


def pad_chunks(data: bytes, chunk_size: int, multiple_of: int):
    """Split ``data`` into fixed-size padded chunk arrays for the device
    path: (bufs uint8[B, chunk_size], lengths int32[B], bfinal bool[B],
    nchunks), B the chunk count rounded up to ``multiple_of``."""
    n = len(data)
    nchunks = max(-(-n // chunk_size), 1)
    b = -(-nchunks // multiple_of) * multiple_of
    bufs = np.zeros((b, chunk_size), dtype=np.uint8)
    lengths = np.zeros(b, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for i in range(nchunks):
        seg = arr[i * chunk_size : (i + 1) * chunk_size]
        bufs[i, : len(seg)] = seg
        lengths[i] = len(seg)
    bfinal = np.zeros(b, dtype=bool)
    bfinal[nchunks - 1] = True
    return bufs, lengths, bfinal, nchunks
