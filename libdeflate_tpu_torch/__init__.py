"""libdeflate_tpu_torch — the PyTorch/CUDA port of libdeflate_tpu.

Counterpart of ``libdeflate_tpu/``.  The port goes slice by slice; this
package holds the lean min-cost-DP compress path (the JAX package's
``compress/tpu_optimal.py::compress_chunks_lean_pallas``) with its two
kernels, and the scalar DEFLATE decoder
(``decompress/pallas_decode.py``) with its kernel, all written by hand in
CUDA C++ for Hopper (``csrc/``).

The package imports ``torch`` and ``numpy`` and nothing of JAX or of the
JAX package.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from .compress.dynamic import (
    compress_chunks_dynamic,
    compress_chunks_dynamic2,
    compress_chunks_dynamic3,
)
from .compress.optimal import compress_chunks_lean
from .compress.pipeline import compress_chunks_static, device_stream_to_bytes
from .decompress.decode import (
    decompress_chunks,
    decompress_chunks_host,
    decompress_chunks_words,
)
from .device import from_numpy_batch, resolve_device

__all__ = [
    "compress_chunks_dynamic",
    "compress_chunks_dynamic2",
    "compress_chunks_dynamic3",
    "compress_chunks_lean",
    "compress_chunks_static",
    "decompress_chunks",
    "decompress_chunks_host",
    "decompress_chunks_words",
    "device_stream_to_bytes",
    "from_numpy_batch",
    "resolve_device",
]
