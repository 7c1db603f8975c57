"""Device selection for the port's entry points.

No counterpart file in ``libdeflate_tpu/``: JAX places arrays on its
default backend.  Here an entry point runs on the CUDA device unless the
caller names another device; a missing CUDA device is an error, never a
silent move to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


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


def from_numpy_batch(bufs, lengths, bfinal, device=None):
    """The JAX entry's inputs (uint8[B, N], int32[B], bool[B], as numpy
    arrays or tensors) as tensors on ``device`` (CUDA when None)."""
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
    return (bufs.to(dev).contiguous(), lengths.to(dev, torch.int64),
            bfinal.to(dev, torch.bool))
