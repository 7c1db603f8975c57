"""Entry points: the flagship compress step, and the chunk-DP dry run.

Counterpart of the repository's ``__graft_entry__.py``: ``entry()`` gives
the flagship chunk compressor (dyn1, ``compress_chunks_dynamic``) with
its example batch, and ``dryrun_multichip(n)`` runs the whole chunk-DP
path, compress and decode, over an n-device mesh on tiny shapes.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from .compress.dynamic import compress_chunks_dynamic
from .compress.pipeline import device_stream_to_bytes
from .device import resolve_device
from .parallel import mesh as mesh_mod
from .parallel.file_codec import gzip_compress_dp


def entry(device=None):
    """(fn, example_args): dyn1 over B = 4 random 64 KiB chunks
    (``np.random.default_rng(0)``), the last one final, placed on
    ``device`` (CUDA when None); ``fn(*args)`` runs there."""
    dev = resolve_device(device)
    B, N = 4, 1 << 16
    rng = np.random.default_rng(0)
    bufs = torch.as_tensor(rng.integers(0, 256, size=(B, N), dtype=np.uint8),
                           device=dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    bfinal = torch.tensor([False, False, False, True], device=dev)
    return (functools.partial(compress_chunks_dynamic, device=dev),
            (bufs, lengths, bfinal))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the full chunk-DP compress step over an n-device mesh on tiny
    shapes, then the decode direction, and check both: the first
    ``n_devices`` of ``devices`` (every CUDA device when None, the
    default mesh), their shards run at once."""
    if devices is None:
        devices = mesh_mod.make_chunk_mesh().devices
    mesh = mesh_mod.make_chunk_mesh(list(devices)[:n_devices])

    rng = np.random.default_rng(1)
    data = (
        b"a tiny but compressible payload, repeated. " * 64
        + rng.integers(0, 256, size=512, dtype=np.uint8).tobytes()
    )
    out = gzip_compress_dp(data, mesh, chunk_size=512, level=6)
    if zlib.decompress(out, 31) != data:
        raise AssertionError("multichip round-trip failed")

    # decode direction: compress independent per-chunk streams (BFINAL on
    # every chunk, the reference benchmark's chunked model), then decode
    # them back through the sharded decompressor and check every byte
    chunk = 512
    bufs, lengths, _, nchunks = mesh_mod.pad_chunks(data, chunk, n_devices)
    bfinal = np.ones(bufs.shape[0], dtype=bool)
    words, total_bits, _, _, _ = mesh_mod.compress_chunks_dp(
        mesh, bufs, lengths, bfinal, level=6
    )
    words = words.cpu().numpy()
    total_bits = total_bits.tolist()
    frags = [
        device_stream_to_bytes(words[i], total_bits[i])
        for i in range(bufs.shape[0])
    ]
    ncap = max(len(f) for f in frags)
    cbufs = np.zeros((bufs.shape[0], ncap), np.uint8)
    in_lens = np.zeros(bufs.shape[0], np.int32)
    for i, f in enumerate(frags):
        cbufs[i, : len(f)] = np.frombuffer(f, np.uint8)
        in_lens[i] = len(f)
    dout, _, _, status, _ = mesh_mod.decompress_chunks_dp(
        mesh, cbufs, in_lens, lengths, chunk
    )
    dout = dout.cpu().numpy()
    status = status.tolist()
    for i in range(nchunks):
        if status[i] != 0:
            raise AssertionError(f"multichip decode status {status[i]}")
        if dout[i, : lengths[i]].tobytes() != bytes(bufs[i, : lengths[i]]):
            raise AssertionError("multichip decode round-trip failed")
