"""The port's entry module (``libdeflate_tpu_torch/entry.py``)
against the repository's ``__graft_entry__.py``.

``entry(device="cpu")``'s flagship step gives the words and total_bits
of the JAX ``entry()``'s ``fn(*args)`` (jitted) on the same B = 4 x
64 KiB random batch; ``dryrun_multichip(8)`` passes on a mesh of eight
CPU devices; without CUDA the device defaults raise.  Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from file_codec_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu_torch import entry as pe


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    want_words, want_bits = (np.asarray(x) for x in jax.jit(jfn)(*jargs))
    fn, args = pe.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    words, total_bits = fn(*args)
    assert total_bits.tolist() == want_bits.astype(np.int64).tolist()
    for i in range(len(args[0])):
        assert lt.device_stream_to_bytes(words[i], total_bits[i]) == \
            want_words[i].astype("<u4").tobytes()[:(want_bits[i] + 7) // 8]


def test_dryrun_multichip_on_eight_cpu_devices():
    pe.dryrun_multichip(8, devices=["cpu"] * 8)


def test_device_defaults_need_cuda():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        lt.make_chunk_mesh()
    with pytest.raises(RuntimeError):
        lt.gzip_compress_dp(b"abc")
    with pytest.raises(RuntimeError):
        pe.entry()
    with pytest.raises(RuntimeError):
        pe.dryrun_multichip(1)
