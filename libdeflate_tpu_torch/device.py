"""Device selection for the port's entry points.

No counterpart file in ``libdeflate_tpu/``: JAX places arrays on its
default backend.  Here an entry point runs on the CUDA device unless the
caller names another device; a missing CUDA device is an error, never a
silent move to the CPU.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# constant tables on each device, by their bytes: a copy from pageable
# host memory waits for the device's queued work, so a table copied in
# every call would stall the calling thread there
_constants: dict[tuple, torch.Tensor] = {}
_constants_lock = threading.Lock()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` for ``None`` (raising when CUDA is absent), else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, dtype) -> torch.Tensor:
    """``x`` itself if it is a tensor, else a CPU tensor of the numpy
    ``dtype``; read-only arrays (``np.frombuffer``) are copied, since
    tensors need writable memory."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(np.asarray(x, dtype), dtype,
                                       ["C", "W"]))


def constant(x, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(np.asarray(x, dtype), device=device)``, copied to
    the device once per value and kept: a table the caller only reads.
    The copy has finished when it is returned, so any stream may read
    it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    arr = np.ascontiguousarray(x, dtype)
    key = (dev, arr.dtype.str, arr.shape, arr.tobytes())
    got = _constants.get(key)
    if got is None:
        with _constants_lock:
            got = _constants.get(key)
            if got is None:
                got = _constants[key] = torch.as_tensor(arr, device=dev)
    return got


def from_numpy_batch(bufs, lengths, bfinal, device=None,
                     non_blocking: bool = False):
    """The JAX entry's inputs (uint8[B, N], int32[B], bool[B], as numpy
    arrays or tensors) as tensors on ``device`` (CUDA when None).  With
    ``non_blocking`` the copies to a CUDA device do not wait for it: the
    small ``lengths`` and ``bfinal`` first, then ``bufs``, which from
    pinned memory the caller must leave unchanged until the device's
    stream has passed the copy."""
    dev = resolve_device(device)
    bufs = as_tensor(bufs, np.uint8)
    lengths = as_tensor(lengths, np.int64)
    bfinal = as_tensor(bfinal, bool)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs must be uint8[B, N], got {bufs.dtype} "
                         f"{tuple(bufs.shape)}")
    B = bufs.shape[0]
    if lengths.shape != (B,) or bfinal.shape != (B,):
        raise ValueError("lengths and bfinal must have shape [B]")
    lengths = lengths.to(dev, torch.int64, non_blocking=non_blocking)
    bfinal = bfinal.to(dev, torch.bool, non_blocking=non_blocking)
    return (bufs.to(dev, non_blocking=non_blocking).contiguous(), lengths,
            bfinal)
