"""The port's optfast DP tier against the JAX package's entries.

``libdeflate_tpu_torch.compress_chunks_optfast`` (device="cpu") against
``libdeflate_tpu/compress/tpu_optimal.py::compress_chunk_optimal`` under
vmap with ``compress_chunks_optfast_pallas``' keywords (B = 2) and
against ``compress_chunks_optfast_pallas(interpret=True)`` (B = 1): the
same words and total_bits, and every fragment inflates through zlib.
The cases are tests/dp_tier_cases.py's.

At 64 KiB chunks and B = 2 the XLA path and the Pallas twin differ: in
the refined pass the Pallas DP reads one match-cost table a 1024-lane
block, chunk 0's, for both chunks' 64 lanes; the port reads each
chunk's own, as the XLA path does.  One test shows it.  Tolerance:
exact.
"""

import zlib

import numpy as np

import libdeflate_tpu_torch as lt
from dp_tier_cases import (  # noqa: F401
    batch,
    check,
    one_torch_thread,
    pallas,
    port,
    xla,
)


def test_optfast_matches_xla():
    check("optfast", False, xla("optfast"))


def test_optfast_matches_pallas_interpret_at_b1():
    check("optfast", True, pallas("optfast"))


def test_per_chunk_tables_xla_not_pallas():
    """B = 2 at 64 KiB: the port equals the XLA path, and the Pallas twin
    differs from both in the chunk whose refined table is not chunk
    0's."""
    bufs, lengths, _ = batch()
    words, total_bits = port("optfast")
    want = xla("optfast")
    pal = pallas("optfast", False)
    assert np.array_equal(total_bits.numpy(), want[1])
    assert pal[1][0] == want[1][0]
    assert pal[1][1] != want[1][1]
    assert not np.array_equal(pal[0][1], words[1].numpy().view(np.uint32))
    # the Pallas stream is still valid DEFLATE, only parsed otherwise
    stream = lt.device_stream_to_bytes(pal[0][1], pal[1][1])
    assert zlib.decompressobj(-15).decompress(stream) == \
        bufs[1, :lengths[1]].tobytes()
