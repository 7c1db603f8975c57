"""The premerge group and multi-block emission against the JAX package's
Pallas path.

``libdeflate_tpu_torch.compress_chunks_optimal_pallas_with`` against
``libdeflate_tpu/compress/tpu_optimal.py::_compress_chunks_optimal_pallas``
in interpret mode, each chunk alone on the JAX side
(``dp_tier_cases.check_pallas_with``), on tests/dp_tier_cases.py's batch
(two 64 KiB chunks, 65536 and 40000 live bytes):

- ``pm_group=64`` on the lean tier's keywords: 64-item premerge groups
  of 23 + 1 words; the words equal the lean tier's;
- ``emit_blocks=4`` on the lean tier's keywords: four blocks a chunk,
  each with its own code, the premerge rows 58 + 1 words wide.

Then ``emit_blocks=4`` on the JAX test's four mixed chunks
(tests/test_pallas_kernels.py::test_multi_block_emit_roundtrip, cut to
64 KiB each: text, noisy records, random bytes, zeros): every fragment
inflates to its chunk.  Words and total_bits exact.
"""

import zlib

import numpy as np
import pytest

import libdeflate_tpu_torch as lt
from dp_tier_cases import (  # noqa: F401
    LEAN,
    N,
    REPO,
    batch,
    check_pallas_with,
    one_torch_thread,
)


@pytest.mark.parametrize("option", ["pm_group 64", "emit_blocks 4"])
def test_pallas_path_option(option):
    options = {"pm_group 64": dict(LEAN, pm_group=64),
               "emit_blocks 4": dict(LEAN, emit_blocks=4)}[option]
    words, total_bits = check_pallas_with(options, batch())
    if option == "pm_group 64":
        lean = lt.compress_chunks_lean(*batch(), device="cpu")
        assert np.array_equal(words.numpy(), lean[0].numpy())
        assert np.array_equal(total_bits.numpy(), lean[1].numpy())


def test_emit_blocks_round_trip_mixed_chunks():
    rng = np.random.default_rng(13)
    survey = ((REPO / "SURVEY.md").read_bytes() * 40)[:N]
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), N // 64)
    noise = rng.integers(0, 256, N, dtype=np.uint8)
    rec = np.where(rng.random(N) < 0.05, noise, rec).astype(np.uint8)
    datas = [survey, rec.tobytes(),
             rng.integers(0, 256, N, dtype=np.uint8).tobytes(), bytes(N)]
    bufs = np.stack([np.frombuffer(d, np.uint8) for d in datas])
    w, t = lt.compress_chunks_optimal_pallas_with(
        bufs, np.full(4, N, np.int32), np.ones(4, bool), device="cpu",
        **LEAN, emit_blocks=4)
    for i, d in enumerate(datas):
        stream = lt.device_stream_to_bytes(w[i], t[i])
        assert zlib.decompress(stream, -15) == d, i
