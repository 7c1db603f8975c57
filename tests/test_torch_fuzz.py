"""The port's fuzz harness (``libdeflate_tpu_torch/experiments/fuzz.py``)
against ``scripts/fuzz.py`` and the JAX package.

``scripts/fuzz.py`` switches JAX to the CPU and resets its backends when
it is imported, so its functions are taken from its source by name
(``ast``) and run against the JAX package here.

- The draws: the port's ``gen_data`` is the script's byte for byte over a
  few seeds and caps (1 MiB jumps included), and the port's decompress,
  compress and device targets leave the generator where the script's
  leave it, on the same inputs.
- The host targets: the blobs of ``Compressor`` and the ``Decompressor``
  4-tuples (raw, zlib and gzip wrappers) on the targets' draws equal the
  JAX package's, on the native backend and on the Python path, with
  cases of a few KiB.
- The device target: its 8 KiB rows through static and dyn1 give the JAX
  package's words and total_bits; its clean and damaged rows through the
  port's plain decoders give the 4-tuples of the JAX FSM
  (``decompress/tpu.py``, B = 8 x 8 KiB into 16384, the shape of
  ``experiments/fsm_cases.py``) and of interpret-mode
  ``decompress_chunks_pallas`` in both size modes (B = 4 x 12288 words
  into 81920, the shape of ``tests/test_torch_decode.py``).
- The run: ``fuzz.run`` with ``device="cpu"`` passes its oracles; a
  decoder that differs from its plain version, or a clean row that does
  not decode, fails it; no device path without CUDA.

Tolerance: exact.
"""

import ast
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from libdeflate_tpu import native_backend as jnb
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu.decompress import pallas_decode as pd
from libdeflate_tpu.decompress import tpu as dtpu
from libdeflate_tpu.formats.deflate import deflate_compress_bound
from libdeflate_tpu_torch import native_backend as nb
from libdeflate_tpu_torch.decompress.decode import pack_streams
from libdeflate_tpu_torch.experiments import fsm_cases as fc
from libdeflate_tpu_torch.experiments import fuzz
from libdeflate_tpu_torch.experiments.corpus import REPO
from libdeflate_tpu_torch.experiments.host_contract import on_backend

K3_B, K3_W, K3_OUT = 4, 12288, 81920      # tests/test_torch_decode.py
FILLER = b"\x03\x00"                      # an empty static final block
JAX_TIERS = {"static": tp.compress_chunks_static,
             "dyn1": td.compress_chunks_dynamic}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs, as in the tier tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script():
    """gen_data, fuzz_decompress and fuzz_compress of scripts/fuzz.py,
    run against the JAX package."""
    tree = ast.parse((REPO / "scripts" / "fuzz.py").read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("gen_data", "fuzz_decompress", "fuzz_compress")]
    ns = {"np": np, "zlib": zlib, "ld": ld,
          "deflate_compress_bound": deflate_compress_bound}
    exec(compile(ast.Module(keep, []), "scripts/fuzz.py", "exec"), ns)
    return ns


SCRIPT = _script()


def _state(rng):
    return rng.bit_generator.state["state"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gen_data_equals_the_script(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    caps = [4096, fuzz.ROW, 1 << 16, 1 << 16, 1 << 16, 100, 1]
    for cap in caps * 6:
        assert fuzz.gen_data(a, cap) == SCRIPT["gen_data"](b, cap)
    assert _state(a) == _state(b)


@pytest.mark.parametrize("seed", [0, 7])
def test_host_targets_draw_as_the_script(seed):
    """Four trials of the script's two host targets (the JAX package, on
    its native backend) and of the port's: the same inputs, and the
    generator left in the same state after each target."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    with on_backend("native", nb, jnb):
        for _ in range(4):
            SCRIPT["fuzz_decompress"](a)
            fuzz.fuzz_decompress(fuzz.decompress_case(b))
            assert _state(a) == _state(b)
            SCRIPT["fuzz_compress"](a)
            fuzz.fuzz_compress(*fuzz.compress_case(b))
            assert _state(a) == _state(b)


def test_device_case_draws_as_the_script():
    """The row and the flipped bit come first, as fuzz.py:136 and :166-168
    draw them."""
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        data, rows = fuzz.device_case(a)
        assert data == SCRIPT["gen_data"](b, fuzz.ROW)
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        stream = c.compress(data) + c.flush()
        assert rows[0] == ("clean", stream)
        if len(stream) > 8:
            bad = bytearray(stream)
            bad[int(b.integers(0, len(bad)))] ^= 1 << int(b.integers(0, 8))
            assert rows[1] == ("bit flip", bytes(bad))
        fuzz.overwrite(b, bytearray(stream))
        b.integers(0, len(stream))
        assert _state(a) == _state(b)
        assert [k for k, _ in rows][-2:] == ["bytes overwritten", "cut"]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_host_targets_equal_jax(backend):
    rng = np.random.default_rng(11)
    with on_backend(backend, nb, jnb):
        for _ in range(6):
            blob = fuzz.decompress_case(rng)
            ours = fuzz.fuzz_decompress(blob)
            d = ld.Decompressor()
            theirs = tuple(fn(blob, fuzz.HOST_CAP, known_size=False)
                           for fn in (d.deflate_decompress, d.zlib_decompress,
                                      d.gzip_decompress))
            assert ours == theirs
            data, level, fmt = fuzz.compress_case(rng, 3 << 10)
            assert fuzz.fuzz_compress(data, level, fmt) == \
                ld.Compressor(level).compress(data, fmt)


def _device_cases(seed, trials):
    rng = np.random.default_rng(seed)
    return [fuzz.device_case(rng) for _ in range(trials)]


CASES = _device_cases(21, 6)
ROWS = [(kind, s, data) for data, rs in CASES for kind, s in rs]


@pytest.mark.parametrize("tier", list(JAX_TIERS))
def test_device_rows_compress_as_jax(tier):
    for data, _ in CASES:
        buf = np.zeros((1, fuzz.ROW), np.uint8)
        buf[0, :len(data)] = np.frombuffer(data, np.uint8)
        lens, bfinal = np.array([len(data)], np.int32), np.ones(1, bool)
        w, t = fuzz.DEVICE_TIERS[tier](buf, lens, bfinal, device="cpu")
        w_j, t_j = JAX_TIERS[tier](jnp.asarray(buf), jnp.asarray(lens),
                                   jnp.asarray(bfinal))
        assert np.array_equal(t.numpy(), np.asarray(t_j))
        assert np.array_equal(w.numpy().view(np.uint32), np.asarray(w_j))
    # the port's own check of the row, on the CPU
    fuzz.compress_row(CASES[0][0], torch.device("cpu"))


def _groups(rows, b):
    for i in range(0, len(rows), b):
        group = rows[i:i + b]
        yield group + [("filler", FILLER, b"")] * (b - len(group))


def test_damaged_rows_decode_as_the_jax_fsm():
    assert sum(kind != "clean" for kind, _, _ in ROWS) >= 12
    for group in _groups(ROWS, fc.B):
        bufs = np.zeros((fc.B, fc.N), np.uint8)
        lens = np.array([len(s) for _, s, _ in group], np.int32)
        for k, (_, s, _) in enumerate(group):
            s = s[:fc.N]
            bufs[k, :len(s)] = np.frombuffer(s, np.uint8)
        want = dtpu.decompress_chunks(jnp.asarray(bufs), jnp.asarray(lens),
                                      fc.OUT)
        got = lt.decompress_chunks_fsm(bufs, lens, fc.OUT, device="cpu")
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("known_size", [True, False])
def test_damaged_rows_decode_as_pallas(known_size):
    for group in _groups(ROWS, K3_B):
        comp = np.zeros((K3_B, K3_W), np.uint32)
        packed, clen = pack_streams(
            [s for _, s, _ in group], 0)
        comp[:, :packed.shape[1]] = packed
        olen = np.array([len(d) if known_size else fuzz.DEC_OUT
                         for _, _, d in group], np.int32)
        w_out, w_st, w_ol, w_cons = (np.asarray(x) for x in
                                     pd.decompress_chunks_pallas(
            jnp.asarray(comp), jnp.asarray(clen), jnp.asarray(olen), K3_OUT,
            known_size=known_size, interpret=True))
        g_out, g_st, g_ol, g_cons = (x.numpy() for x in
                                     lt.decompress_chunks_words(
            comp, clen, olen, K3_OUT, known_size=known_size, device="cpu"))
        assert np.array_equal(g_st, w_st) and np.array_equal(g_ol, w_ol)
        assert np.array_equal(g_cons, w_cons)
        # on a failure the reference leaves its output ring unflushed and
        # past out_len stale ring words; the port flushes, and zeros
        for k in range(K3_B):
            if w_st[k] == 0:
                assert np.array_equal(g_out[k, :g_ol[k]], w_out[k, :w_ol[k]])
            assert not g_out[k, g_ol[k]:].any()


def test_run_on_the_cpu_passes_its_oracles():
    res = fuzz.run(4, 3, 1, device="cpu", log=lambda line: None)
    c = res["counts"]
    assert c["device compress rows"] == 4 and c["host compress"] == 4
    assert c["rows"] == 4 + c["damaged"] and c["damaged"] >= 8
    for name in fuzz.DECODERS:
        assert c[f"{name}: success"] + c[f"{name}: failure"] == c["damaged"]
    assert len(res["row_lengths"]) == 4


def test_oracles_catch_a_wrong_decoder():
    rows = ROWS[:4]
    dev = torch.device("cpu")
    got = fuzz.decode_rows([s for _, s, _ in rows],
                           [len(d) for _, _, d in rows], dev)
    fuzz.check_rows(rows, got, got)
    for name in fuzz.DECODERS:
        bad = {k: tuple(x.copy() for x in v) for k, v in got.items()}
        bad[name][3][1] += 1     # one row's consumed off by one
        with pytest.raises(AssertionError, match="consumed differs"):
            fuzz.check_rows(rows, bad, got)
        bad = {k: tuple(x.copy() for x in v) for k, v in got.items()}
        bad[name][1][0, 0] ^= 1  # the clean row's first byte
        with pytest.raises(AssertionError, match="clean zlib-6 stream"):
            fuzz.check_rows(rows, bad)


def test_no_device_path_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        fuzz.run(1, 0, 1)
    with pytest.raises(RuntimeError):
        fuzz.main(["--iters", "1", "--device-every", "1"])
