"""The port's checksums against zlib and the JAX package's, on the CPU.

libdeflate_tpu_torch/ops/checksums.py against
libdeflate_tpu/ops/checksums_jax.py and zlib: ``crc32_chunks`` and
``adler32_chunks`` at the shape of tests/test_checksums.py (8 x 4096 bytes,
lengths 0 to 4096); ``crc32_fixed`` and ``adler32_fixed`` on randomized
sizes, lengths and initial values (the JAX functions on one padded shape,
since the result does not depend on the bytes past ``length``); the
Adler-32 s2-overflow edge (5553 bytes of 0xFF from 0xFFFFFFFF).  The port's
libdeflate_tpu_torch/ops/crc32_math.py tables against the JAX package's,
and its table-driven ``crc32_combine_by_table`` against ``crc32_combine``
and zlib.

Tolerance: exact.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.ops import checksums_jax as cj
from libdeflate_tpu.ops import crc32_math as jm
from libdeflate_tpu_torch.ops import checksums as ck
from libdeflate_tpu_torch.ops import crc32_math as pm

N_MAX = 40000
ORACLE = {"crc32": zlib.crc32, "adler32": zlib.adler32}
PORT_FIXED = {"crc32": ck.crc32_fixed, "adler32": ck.adler32_fixed}
JAX_FIXED = {"crc32": jax.jit(cj.crc32_fixed),
             "adler32": jax.jit(cj.adler32_fixed)}


@pytest.mark.parametrize("name", ["CRC_BYTE_TABLE", "CRC_BIT_TABLE",
                                  "ADVANCE_POW2", "INV_ADVANCE_POW2",
                                  "BLOCK_BITS_MATRIX", "CRC_BLOCK"])
def test_crc_tables_match_reference(name):
    got, want = getattr(pm, name), getattr(jm, name)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert np.array_equal(got, want)


def test_crc32_combine_matches_reference(rng):
    for _ in range(5):
        a, b = (int(x) for x in rng.integers(0, 2**32, 2))
        n = int(rng.integers(0, 1 << 20))
        assert pm.crc32_combine(a, b, n) == jm.crc32_combine(a, b, n)
    x = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    assert pm.crc32_combine(zlib.crc32(x[:1000]), zlib.crc32(x[1000:]),
                            2000) == zlib.crc32(x)


@pytest.mark.parametrize("len2", [0, 1, 2, 65535, 1 << 20, (1 << 20) + 1,
                                  (1 << 32) + 5, "random"])
def test_crc32_combine_by_table(len2, rng):
    """Equal to ``crc32_combine`` on random registers and, where the data
    fits, to zlib's CRC-32 of the joined data."""
    lens = ([int(n) for n in rng.integers(0, 1 << 24, 6)] if len2 == "random"
            else [len2])
    for n in lens:
        for _ in range(3):
            a, b = (int(x) for x in rng.integers(0, 2**32, 2))
            assert pm.crc32_combine_by_table(a, b, n) == \
                pm.crc32_combine(a, b, n)
        if n <= (1 << 20) + 1:
            x = rng.integers(0, 256, 100 + n, dtype=np.uint8).tobytes()
            assert pm.crc32_combine_by_table(
                zlib.crc32(x[:100]), zlib.crc32(x[100:]), n) == zlib.crc32(x)


def test_crc32_combine_by_table_over_a_file_with_a_short_last_chunk(rng):
    data = rng.integers(0, 256, 5 * 65536 + 1234, dtype=np.uint8).tobytes()
    crc = 0
    for i in range(0, len(data), 65536):
        chunk = data[i:i + 65536]
        crc = pm.crc32_combine_by_table(crc, zlib.crc32(chunk), len(chunk))
    assert crc == zlib.crc32(data)


@pytest.mark.parametrize("name", ["crc32", "adler32"])
def test_chunks_match_zlib_and_reference(name, rng):
    lengths = np.array([0, 1, 17, 4096, 2048, 5, 4095, 100], np.int32)
    bufs = rng.integers(0, 256, size=(8, 4096), dtype=np.uint8)
    jfn = cj.crc32_chunks if name == "crc32" else cj.adler32_chunks
    pfn = ck.crc32_chunks if name == "crc32" else ck.adler32_chunks
    want = np.asarray(jfn(jnp.asarray(bufs), jnp.asarray(lengths)))
    got = pfn(bufs, lengths, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (8,)
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == [ORACLE[name](bufs[i, :n].tobytes())
                            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["crc32", "adler32"])
def test_fixed_random_sizes_and_inits(name, seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(10):
        n = int(rng.integers(0, N_MAX))
        length = int(rng.integers(0, n + 1))
        init = int(rng.integers(0, 2**32))
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        got = int(PORT_FIXED[name](buf, length, init, device="cpu"))
        assert got == ORACLE[name](buf[:length].tobytes(), init)
        padded = np.zeros(N_MAX, np.uint8)
        padded[:n] = buf
        want = JAX_FIXED[name](jnp.asarray(padded), jnp.int32(length),
                               jnp.uint32(init))
        assert got == int(want)


def test_adler_s2_overflow_edge():
    data = np.full(5553, 0xFF, np.uint8)
    got = int(ck.adler32_fixed(data, 5553, 0xFFFFFFFF, device="cpu"))
    assert got == zlib.adler32(data.tobytes(), 0xFFFFFFFF)
    want = JAX_FIXED["adler32"](jnp.asarray(data), jnp.int32(5553),
                                jnp.uint32(0xFFFFFFFF))
    assert got == int(want)


def test_empty_and_defaults():
    empty = np.zeros(0, np.uint8)
    assert int(ck.adler32_fixed(empty, 0, device="cpu")) == 1
    assert int(ck.crc32_fixed(empty, 0, device="cpu")) == 0
    assert int(ck.adler32_fixed(empty, 0, 0xDEADBEEF,
                                device="cpu")) == 0xDEADBEEF
    assert int(ck.crc32_fixed(empty, 0, 123, device="cpu")) == 123
    digits = np.frombuffer(b"123456789", np.uint8)
    assert int(ck.crc32_fixed(digits, 9, device="cpu")) == 0xCBF43926


def test_one_megabyte_chunks_match_zlib():
    rng = np.random.default_rng(3)
    bufs = rng.integers(0, 256, (2, 1 << 20), dtype=np.uint8)
    bufs[1, :1 << 19] = 0x41
    lens = np.array([1 << 20, (1 << 20) - 12345])
    assert ck.crc32_chunks(bufs, lens, device="cpu").tolist() == [
        zlib.crc32(bufs[k, :n].tobytes()) for k, n in enumerate(lens)]
    assert ck.adler32_chunks(bufs, lens, device="cpu").tolist() == [
        zlib.adler32(bufs[k, :n].tobytes()) for k, n in enumerate(lens)]


def test_inputs_checked_and_cuda_by_default():
    with pytest.raises(ValueError):
        ck.crc32_chunks(torch.zeros(2, 8, dtype=torch.int32), [8, 8],
                        device="cpu")
    with pytest.raises(ValueError):
        ck.adler32_chunks(np.zeros((2, 8), np.uint8), [8], device="cpu")
    with pytest.raises(ValueError):
        ck.crc32_fixed(np.zeros((2, 8), np.uint8), 8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ck.crc32_chunks(np.zeros((1, 8), np.uint8), [8])
