"""The compress -> decode round trip of the port, on the CPU.

The port's own ``compress_chunks_lean`` streams of the batches of
tests/test_torch_slice.py (two 64 KiB chunks each: SURVEY.md text with
noisy records, the same with the second chunk cut to 40 000 bytes, zeros
with random bytes), each chunk a final block, with zlib level-6 and
``Z_FIXED`` streams of the same chunks, are decoded by
``libdeflate_tpu_torch.decompress_chunks_words(..., device="cpu")`` and by
``libdeflate_tpu/decompress/pallas_decode.py::decompress_chunks_pallas(...,
interpret=True)`` in known-size mode.  The compressed words are padded by
2 * STAGE_W zero words, as ``decompress_chunks_pallas_host`` pads them.
Tolerance: exact -- both decoders return every chunk, and all four outputs
agree.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

import libdeflate_tpu_torch as lt
from libdeflate_tpu.decompress import pallas_decode as pd
from libdeflate_tpu_torch.decompress.tables import STAGE_W
from tests.test_torch_slice import N, _batch


def _zlib_words(raw, width, strategy):
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, strategy)
    s = c.compress(raw) + c.flush()
    row = np.zeros(width, np.uint32)
    pad = (-len(s)) % 4
    row[: (len(s) + pad) // 4] = np.frombuffer(s + b"\0" * pad, np.uint32)
    return row, len(s)


@pytest.mark.parametrize("kind", ["text_records", "short_second",
                                  "zeros_random"])
def test_compress_decode_roundtrip(kind):
    bufs, lengths, _ = _batch(kind)
    lengths = np.asarray(lengths, np.int32)
    words, total_bits = lt.compress_chunks_lean(
        bufs, lengths, np.ones(2, bool), device="cpu")
    width = words.shape[1] + 2 * STAGE_W
    rows = [np.pad(words.numpy().view(np.uint32), ((0, 0), (0, 2 * STAGE_W)))]
    clen = [(total_bits.numpy() + 7) // 8]
    for strategy in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED):
        z = [_zlib_words(bufs[k, :lengths[k]].tobytes(), width, strategy)
             for k in range(2)]
        rows.append(np.stack([r for r, _ in z]))
        clen.append(np.array([n for _, n in z]))
    comp = np.concatenate(rows)
    clen = np.concatenate(clen).astype(np.int32)
    out_len = np.tile(lengths, 3)

    want = [np.asarray(x) for x in pd.decompress_chunks_pallas(
        jnp.asarray(comp), jnp.asarray(clen), jnp.asarray(out_len), N,
        interpret=True)]
    got = [x.numpy() for x in lt.decompress_chunks_words(
        comp, clen, out_len, N, device="cpu")]
    for k in range(comp.shape[0]):
        n = out_len[k]
        raw = bufs[k % 2, :n]
        assert (got[1][k], got[2][k], got[3][k]) == (0, n, clen[k]), k
        assert (want[1][k], want[2][k], want[3][k]) == (0, n, clen[k]), k
        assert np.array_equal(got[0][k, :n], raw), k
        assert np.array_equal(want[0][k, :n], raw), k
        assert not got[0][k, n:].any(), k
