"""Chunk data parallelism over a list of devices.

Counterpart of ``libdeflate_tpu/parallel/mesh.py``.  The JAX mesh is one
program over every device: ``shard_map`` runs the chunk compressor on
each device's contiguous shard of the batch, every shard at the same
time, and ``all_gather`` hands every shard the per-chunk sizes.  Here one
process drives the same split over a ``ChunkMesh``, a tuple of
``torch.device``, with every shard at once:

- each shard runs in a worker thread of its own (one
  ``threading.Thread`` a shard, all started before any is joined), and
  the one shard of a one-device mesh on the calling thread, as
  ``shard_map`` over one device is a plain call: the chunk compressor of
  its level on its own device, as one batched call (the JAX shard's
  ``vmap``), and the per-chunk device checksums beside it
  (``ops/checksums.py``), or the decoder;
- a CUDA shard runs on its device as the current device and on a
  ``torch.cuda.Stream`` of its own (one a device and shard index, kept
  across calls), which first waits for the caller's stream: the calling
  thread has put the shard's inputs on its device there.  Every kernel
  wrapper launches on its tensors' device and that device's current
  stream of the calling thread (``_build.launch_context``), so the
  shards' kernels run side by side on one card or across cards; a CPU
  shard runs in its thread with no stream;
- the caller's stream on each device waits for an event at the end of
  each of its shards' streams; ``compress_shards`` hands back each
  shard's results on its own device, in shard order, and the whole-file
  assembly (``parallel/file_codec.py``) reads every card's sizes and
  kept bytes from there, so no word crosses between cards.
  ``compress_chunks_dp`` and ``decompress_chunks_dp`` then gather the
  shards' results in shard order into one ``[B]`` tensor on the mesh's
  first device, the JAX mesh's contract.  A tensor that one stream
  allocated and another reads is marked with ``record_stream``;
- the compress shards' chunks go to their devices from the caller's
  batch (pinned host memory in the whole-file entry) without blocking,
  each on its device's caller stream, every copy issued before any shard
  starts;
- a shard that raises makes the call raise its error (the first in shard
  order) once every thread has ended;
- with a profiler session on, the call's ranges (``utils.profiling.span``)
  are ``mesh.inputs`` (the shards' inputs to their devices, one
  ``mesh.card_in`` inside it a compress shard), ``mesh.shards`` (from the
  first shard's start to the last one's end and the event waits),
  ``mesh.gather`` where the results are gathered and, in each compress
  shard, ``stage.crc32`` and ``stage.adler32`` beside the tier entry's
  stages.

The default mesh is every CUDA device, as JAX's ``jax.devices()``; on a
machine with one card, that card alone, whose batch the tier entry runs
as one call.  Repeated devices are separate shards, so
``["cuda:0"] * 4`` runs four shards at once on one card.  Chunk streams
are byte-aligned sync-flushed DEFLATE fragments, so ordered assembly is
concatenation, and every chunk's bits are independent of the mesh's
size.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..compress.dynamic import compress_chunks_dynamic
from ..compress.optimal import MESH_LEVEL_OPTIONS, compress_chunks_optimal_with
from ..compress.pipeline import compress_chunks_static
from ..decompress import decode, fsm
from ..device import as_tensor, from_numpy_batch, resolve_device
from ..ops.checksums import adler32_chunks, crc32_chunks
from ..utils.profiling import span


@dataclass(frozen=True)
class ChunkMesh:
    """The devices a batch of chunks is split over, in shard order."""

    devices: tuple[torch.device, ...]


def make_chunk_mesh(devices=None) -> ChunkMesh:
    """A mesh over ``devices`` (names or ``torch.device``s; repeats are
    separate shards, so ``["cpu"] * 8`` is an 8-device CPU mesh and
    ``["cuda:0"] * 4`` four shards on one card; "cuda" is the current
    CUDA device), by default every CUDA device, as ``jax.devices()``.
    Without CUDA the default raises: the mesh never falls back to the
    CPU."""
    if devices is None:
        resolve_device()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("a chunk mesh needs at least one device")
    return ChunkMesh(devices)


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


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


# each shard's stream, by (device, shard index), made once: the caching
# allocator keeps freed blocks for the stream that allocated them, so a
# new stream a call would allocate every call's memory anew
_side_streams: dict[tuple[torch.device, int], torch.cuda.Stream] = {}
_side_lock = threading.Lock()


def _side_stream(dev: torch.device, k: int) -> torch.cuda.Stream:
    with _side_lock:
        side = _side_streams.get((dev, k))
        if side is None:
            side = _side_streams[dev, k] = torch.cuda.Stream(dev)
    return side


def _shard_call(k: int, dev: torch.device, fn, args, caller):
    """fn(dev, *args) of shard k in this worker thread: on a CUDA shard
    with ``dev`` current and on the shard's stream, which first waits for
    ``caller`` (the caller's stream on dev, which put args there).
    Returns (fn's tuple of tensors, the event at its stream's end or
    None)."""
    if dev.type != "cuda":
        return fn(dev, *args), None
    with torch.cuda.device(dev):
        side = _side_stream(dev, k)
        side.wait_stream(caller)
        for a in args:
            a.record_stream(side)
        with torch.cuda.stream(side):
            out = fn(dev, *args)
        done = torch.cuda.Event()
        done.record(side)
    return out, done


def _at_once(mesh: ChunkMesh, fn, shard_args):
    """fn(device, *args) for every shard at once, one worker thread a
    shard (a one-device mesh's shard on the calling thread),
    ``shard_args`` each shard's tensors on its device.  Returns each
    shard's tuple of tensors on its own device, in shard order, the
    caller's stream on that device waiting for the shard's.  A shard's
    error is raised once every thread has ended."""
    callers = {dev: torch.cuda.current_stream(dev) for dev in mesh.devices
               if dev.type == "cuda"}
    ended = [None] * len(mesh.devices)

    def run(k, dev, args):
        try:
            ended[k] = _shard_call(k, dev, fn, args, callers.get(dev)), None
        except BaseException as e:          # raised once every shard ends
            ended[k] = None, e

    with span("mesh.shards"):
        if len(mesh.devices) == 1:
            (dev,), (args,) = mesh.devices, shard_args
            ended[0] = _shard_call(0, dev, fn, args, callers.get(dev)), None
        else:
            threads = [threading.Thread(target=run, args=(k, dev, args),
                                        name=f"chunk-shard_{k}")
                       for k, (dev, args) in enumerate(zip(mesh.devices,
                                                           shard_args))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        outs = []
        for dev, (result, error) in zip(mesh.devices, ended):
            if error is not None:
                raise error
            out, done = result
            if done is not None:
                callers[dev].wait_event(done)
                for t in out:
                    t.record_stream(callers[dev])
            outs.append(out)
    return outs


def _gather(mesh: ChunkMesh, outs):
    """Each field of the shards' tuples concatenated in shard order on the
    mesh's first device."""
    lead = mesh.devices[0]
    with span("mesh.gather"):
        return [torch.cat([p.to(lead) for p in col]) for col in zip(*outs)]


def compress_shards(mesh: ChunkMesh, bufs, lengths, bfinal, level: int = 1):
    """Compress [B, N] chunks data-parallel over the mesh, without the
    gather: each shard's (words int32[B/n, W], total_bits, crcs, adlers)
    on its own device, in shard order.

    B must be a multiple of the mesh size n (pad with empty chunks).  Each
    shard's rows go to its device on that device's caller stream without
    blocking (truly asynchronous from pinned ``bufs``, which the caller
    leaves unchanged until it has waited on the results), one
    ``mesh.card_in`` range a shard; then every shard runs at once
    (``_at_once``)."""
    compress = chunk_compressor(level)
    bufs = as_tensor(bufs, np.uint8)
    lengths = as_tensor(lengths, np.int64)
    bfinal = as_tensor(bfinal, bool)

    def shard(dev, b, n, f):
        words, total_bits = compress(b, n, f, device=dev)
        with span("stage.crc32"):
            crcs = crc32_chunks(b, n, device=dev)
        with span("stage.adler32"):
            adlers = adler32_chunks(b, n, device=dev)
        return words, total_bits, crcs, adlers

    with span("mesh.inputs"):
        shard_args = []
        for dev, part in _shards(mesh, bufs.shape[0]):
            with span("mesh.card_in"):
                shard_args.append(from_numpy_batch(
                    bufs[part], lengths[part], bfinal[part], dev,
                    non_blocking=True))
    return _at_once(mesh, shard, shard_args)


def compress_chunks_dp(mesh: ChunkMesh, bufs, lengths, bfinal,
                       level: int = 1):
    """Compress [B, N] chunks data-parallel over the mesh.

    B must be a multiple of the mesh size (pad with empty chunks).  Every
    shard runs at once (``compress_shards``).  Returns (words int32[B, W]
    holding the uint32 bit patterns, total_bits [B], crcs [B], adlers [B],
    all_bits [B]), gathered on the mesh's first device.  Pinned ``bufs``
    are read asynchronously: leave them unchanged until the results have
    been waited on."""
    words, total_bits, crcs, adlers = _gather(mesh, compress_shards(
        mesh, bufs, lengths, bfinal, level))
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
    the plain version on the CPU), every shard at once.  Known-size
    contract at the mesh layer: a chunk that decodes (status 0) to other
    than its ``out_lens`` is BAD_DATA (1).  Returns (out uint8[B, out_cap],
    out_lens [B], consumed [B], status [B], all_lens [B]) on the mesh's
    first device."""
    decode_fn = {"fsm": fsm.decompress_chunks,
                 "pallas": decode.decompress_chunks}[
        resolve_decoder(decoder, mesh.devices)]
    bufs = as_tensor(bufs, np.uint8)
    in_lens = as_tensor(in_lens, np.int32)
    out_lens = as_tensor(out_lens, np.int32)

    def shard(dev, b, n, want):
        out, oplens, consumed, status = decode_fn(b, n, out_cap, device=dev)
        status = torch.where((status == 0) & (oplens != want),
                             torch.ones_like(status), status)
        return out, oplens, consumed, status

    with span("mesh.inputs"):
        shard_args = [(bufs[part].to(dev), in_lens[part].to(dev),
                       out_lens[part].to(dev, torch.int32))
                      for dev, part in _shards(mesh, bufs.shape[0])]
    out, oplens, consumed, status = _gather(mesh, _at_once(mesh, shard,
                                                           shard_args))
    return out, oplens, consumed, status, oplens.clone()


def pad_chunks(data: bytes, chunk_size: int, multiple_of: int, alloc=None):
    """Split ``data`` into fixed-size padded chunk arrays for the device
    path: (bufs uint8[B, chunk_size], lengths int32[B], bfinal bool[B],
    nchunks), B the chunk count rounded up to ``multiple_of``.

    ``bufs`` is a fresh zeroed array, or with ``alloc`` the first B rows
    of ``alloc(B * chunk_size)``, a writable CPU uint8 tensor (the
    whole-file entry's batch buffer, kept across calls): the file goes in
    as one copy, then the last chunk's tail and the padding rows are
    zeroed, so nothing of an earlier file is left in them."""
    n = len(data)
    nchunks = max(-(-n // chunk_size), 1)
    b = -(-nchunks // multiple_of) * multiple_of
    if alloc is None:
        bufs = np.zeros((b, chunk_size), dtype=np.uint8)
        flat = bufs.reshape(-1)
    else:
        bufs = alloc(b * chunk_size)[: b * chunk_size].view(b, chunk_size)
        flat = bufs.numpy().reshape(-1)
        flat[n:] = 0
    flat[:n] = np.frombuffer(data, dtype=np.uint8)
    lengths = np.zeros(b, dtype=np.int32)
    lengths[:nchunks] = chunk_size
    lengths[nchunks - 1] = n - (nchunks - 1) * chunk_size
    bfinal = np.zeros(b, dtype=bool)
    bfinal[nchunks - 1] = True
    return bufs, lengths, bfinal, nchunks
