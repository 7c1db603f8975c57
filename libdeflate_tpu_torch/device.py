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
