"""libdeflate_tpu_torch — the PyTorch/CUDA port of libdeflate_tpu.

Counterpart of ``libdeflate_tpu/``.  The port goes slice by slice; this
package holds the libdeflate contract of ``api.py`` (result codes,
``Compressor``, ``Decompressor``, the bounds and the checksums, exported
under the JAX package's names) over the host engine (the native C++ codec
built from ``native/ldtpu_native.cpp``, else the numpy/Python parsers and
decoder), the compress tiers (the JAX package's min-cost-DP tiers of
``compress/tpu_optimal.py`` -- lean, optfast, optimal, optimal2, deep and
``compress_chunk_optimal`` at any keywords, and
``_compress_chunks_optimal_pallas`` with every option ``scripts/`` uses --
and the greedy/lazy static and dynamic tiers, with their ``lcp`` and
``depth``) with their two kernels, the scalar
DEFLATE decoder (``decompress/pallas_decode.py``) with its kernel, the
FSM decoder (``decompress/tpu.py``, exported as ``decompress_chunks_fsm``
and ``deflate_decompress_chunk``) with a kernel of its own, the
whole-file chunk-parallel codec over a device mesh (``parallel/``, the
formats, and the entry module ``entry.py``), the programs
(``programs/gzip_cli``, ``benchmark`` and ``checksum``, each run as
``python -m libdeflate_tpu_torch.programs.<name>``) with
``utils/profiling.py``, and the measurement path, all kernels written by
hand in CUDA C++ for Hopper (``csrc/``).

The package imports ``torch`` and ``numpy`` and nothing of JAX or of the
JAX package.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (the whole-file codec: a mesh of CPU devices);
the contract runs on the host, as the JAX package's does, and takes no
device.
"""

__version__ = "0.1.0"

from .api import (
    BAD_DATA,
    INSUFFICIENT_SPACE,
    SHORT_OUTPUT,
    SUCCESS,
    Compressor,
    Decompressor,
    adler32,
    adler32_combine,
    crc32,
    crc32_combine,
    deflate_compress_bound,
    gzip_compress_bound,
    zlib_compress_bound,
)
from .compress.dynamic import (
    compress_chunks_dynamic,
    compress_chunks_dynamic2,
    compress_chunks_dynamic3,
    compress_chunks_dynamic_with,
)
from .compress.optimal import (
    compress_chunks_lean,
    compress_chunks_optfast,
    compress_chunks_optimal,
    compress_chunks_optimal2,
    compress_chunks_optimal_deep,
    compress_chunks_optimal_pallas_with,
    compress_chunks_optimal_with,
)
from .compress.pipeline import compress_chunks_static, device_stream_to_bytes
from .decompress.decode import (
    decompress_chunks,
    decompress_chunks_host,
    decompress_chunks_words,
)
from .decompress.fsm import decompress_chunks as decompress_chunks_fsm
from .decompress.fsm import deflate_decompress_chunk
from .device import from_numpy_batch, resolve_device
from .parallel.file_codec import (
    deflate_compress_dp,
    gzip_compress_dp,
    zlib_compress_dp,
)
from .parallel.mesh import (
    compress_chunks_dp,
    decompress_chunks_dp,
    make_chunk_mesh,
    resolve_decoder,
)

__all__ = [
    "BAD_DATA",
    "Compressor",
    "Decompressor",
    "INSUFFICIENT_SPACE",
    "SHORT_OUTPUT",
    "SUCCESS",
    "adler32",
    "adler32_combine",
    "compress_chunks_dp",
    "compress_chunks_dynamic",
    "compress_chunks_dynamic2",
    "compress_chunks_dynamic3",
    "compress_chunks_dynamic_with",
    "compress_chunks_lean",
    "compress_chunks_optfast",
    "compress_chunks_optimal",
    "compress_chunks_optimal2",
    "compress_chunks_optimal_deep",
    "compress_chunks_optimal_pallas_with",
    "compress_chunks_optimal_with",
    "compress_chunks_static",
    "crc32",
    "crc32_combine",
    "decompress_chunks",
    "decompress_chunks_dp",
    "decompress_chunks_fsm",
    "decompress_chunks_host",
    "decompress_chunks_words",
    "deflate_compress_bound",
    "deflate_compress_dp",
    "deflate_decompress_chunk",
    "device_stream_to_bytes",
    "from_numpy_batch",
    "gzip_compress_bound",
    "gzip_compress_dp",
    "make_chunk_mesh",
    "resolve_decoder",
    "resolve_device",
    "zlib_compress_bound",
    "zlib_compress_dp",
]
