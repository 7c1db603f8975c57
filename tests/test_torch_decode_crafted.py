"""K3's crafted inputs: the port's decoder against the JAX package's, on the CPU.

``decompress_chunks_words(..., device="cpu")`` (the plain version of K3)
against ``decompress_chunks_pallas(..., interpret=True)``, in known-size
and unknown-size mode, on the K3 sets of
libdeflate_tpu_torch/experiments/crafted_streams.py, which chip_smoke.py
also holds the CUDA kernel to: matches of every distance 1-40 at lengths 3,
31, 32, 33 and 258; distance-32768 matches whose source lies in the half
flushed before; items across 32 KiB boundaries; stored blocks longer than
the 16 KiB input ring, across staging moves; stored blocks landing on ring
segment edges before a Huffman block; stored LEN past the data; output
past out_bytes; failures in the middle of a window.  The valid streams
must also give zlib's bytes, and a few sets go through the unknown-size
bytes entry too.

Tolerance: exact, as in tests/test_torch_decode.py, whose batch shapes
(B = 4 rows of W = 12288 words into 81920 bytes; bytes [4, 40960] into
81920) this file reuses.
"""

import zlib

import numpy as np
import pytest

from libdeflate_tpu_torch.experiments import crafted_streams as cs
from tests.test_torch_decode import B, OUT_BYTES, W, _both_bytes, _both_words

SETS = cs.decode_sets(cs.repo_text())


def test_sets_fit_the_batch():
    assert (cs.DEC_B, cs.W, cs.DEC_OUT_BYTES) == (B, W, OUT_BYTES)
    for streams, out_lens, caps in SETS.values():
        assert len(streams) == len(out_lens) == len(caps) <= B
        assert max(map(len, streams)) <= 4 * (W - 2048)


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("name", list(SETS))
def test_crafted_sets(name, known):
    streams, out_lens, caps = SETS[name]
    out, st, ol, _ = _both_words(streams, out_lens if known else caps, known)
    # where zlib decodes the stream to the expected length, so must K3
    for k, s in enumerate(streams):
        try:
            raw = zlib.decompressobj(-15).decompress(s)
        except zlib.error:
            continue
        limit = out_lens[k] if known else caps[k]
        if len(raw) == out_lens[k] and len(raw) <= limit:
            assert (st[k], ol[k]) == (0, len(raw)), (name, k)
            n = min(len(raw), OUT_BYTES)
            assert out[k, :n].tobytes() == raw[:n], (name, k)


def test_stored_len_past_the_data():
    """LEN 5000 reads the zero padding and passes; LEN 60000 is BAD once
    the copy reaches byte 4 * W_pad - 8 of the row; LEN 60000 after 20000
    bytes of output stops at the same bound, in the middle of a window."""
    streams, out_lens, caps = SETS["stored LEN past the data"]
    _, st, ol, cons = _both_words(streams, caps, False)
    assert (st[0], ol[0], cons[0]) == (0, 5000, 105)
    assert (st[1], ol[1], cons[1]) == (1, 4 * W - 8 - 5, 105)
    assert st[2] == 1 and 65536 < ol[2] < 80000 and ol[2] % 32768


def test_failures_mid_window():
    streams, out_lens, caps = SETS["failure in the middle of a window"]
    out, st, ol, _ = _both_words(streams, out_lens, True)
    assert list(st[:4]) == [1, 1, 1, 1]
    assert ol[0] == 20000 and ol[1] == 50000 and ol[2] == 60001
    assert 47000 - 258 < ol[3] <= 47000
    # out holds every byte decoded before the failure, zeros after
    for k in range(4):
        assert out[k, ol[k] - 300:ol[k]].any() and not out[k, ol[k]:].any()


def test_output_past_out_bytes():
    streams, out_lens, caps = SETS["output past out_bytes"]
    for known, lens in ((True, out_lens), (False, caps)):
        out, st, ol, _ = _both_words(streams, lens, known)
        assert list(st[:3]) == [0, 0, 1] and list(ol[:2]) == [90000, 81921]
        assert ol[2] <= 85000
        raw = zlib.decompressobj(-15).decompress(streams[0])
        assert out[0].tobytes() == raw[:OUT_BYTES]


@pytest.mark.parametrize("name", ["distance 32768 into the flushed half",
                                  "stored blocks longer than the ring",
                                  "stored LEN past the data"])
def test_bytes_entry(name):
    _both_bytes(SETS[name][0])


def test_chain_counts():
    """The plain version's count of K3's chain: a stored block is one token
    and no lookup; only a match looks up an offset, so K3 has K4's tokens
    and at most its lookups; the counts leave the results alone."""
    import torch

    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk

    assert dd.chain_counts(*cs.stored_past_the_data()).tolist() == \
        [[1, 1], [0, 0]]
    assert dd.chain_counts(*cs.incomplete_codes()).tolist() == \
        [[3, 3], [3, 4]]
    rows = cs.bursts_across_staging_moves(cs.repo_text())
    k3, k4 = dd.chain_counts(*rows), tk.chain_counts(*rows)
    assert (k3[0] == k4[0]).all() and (k3[1] <= k4[1]).all()
    assert (k3[1] >= k3[0]).all()
    before = dd.decompress_chunks_words(*rows, OUT_BYTES, device="cpu")
    dd.chain_counts(*rows)
    after = dd.decompress_chunks_words(*rows, OUT_BYTES, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(before, after))
