"""The port's greedy/lazy compress tiers against the JAX package's entries.

libdeflate_tpu_torch's compress_chunks_static, compress_chunks_dynamic,
compress_chunks_dynamic2 and compress_chunks_dynamic3 with device="cpu"
against libdeflate_tpu/compress/tpu_pipeline.py::compress_chunks_static
and tpu_dynamic.py::compress_chunks_dynamic{,2,3} (XLA) and
compress_chunks_dynamic{,2,3}_pallas(interpret=True): the same words and
total_bits, and every fragment inflates through zlib.  Batches of two 64
KiB chunks made with numpy from fixed seeds: this repository's SURVEY.md
text and noisy 64-byte records, bfinal mixed, full and partial (40000
and 4095 bytes) live lengths; the records beside an 8-letter alphabet;
zeros beside random bytes; 60 text bytes (a static block) beside 200
letters (a dynamic one); one 256 KiB dyn1 chunk (two 128 KiB segments,
tests/test_tpu_dynamic.py::test_wide_window_single_pass_roundtrip).
Also the code-length build at refine 16 and max_len 15 against
tpu_dynamic._build_code_lens on crafted histograms.  Tolerance: exact.
"""

import functools
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import dynamic as pd
from libdeflate_tpu_torch.compress import scan_kernels

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite may run its
    files in parallel workers, and torch's OpenMP regions on [B, 64 KiB]
    tensors slow down by orders of magnitude when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

PORT = {"static": lt.compress_chunks_static,
        "dyn1": lt.compress_chunks_dynamic,
        "dyn2": lt.compress_chunks_dynamic2,
        "dyn3": lt.compress_chunks_dynamic3}
JAX = {"static": tp.compress_chunks_static,
       "dyn1": td.compress_chunks_dynamic,
       "dyn2": td.compress_chunks_dynamic2,
       "dyn3": td.compress_chunks_dynamic3}
PALLAS = {"dyn1": td.compress_chunks_dynamic_pallas,
          "dyn2": td.compress_chunks_dynamic2_pallas,
          "dyn3": td.compress_chunks_dynamic3_pallas}


def _chunks():
    rng = np.random.default_rng(11)
    raw = (REPO / "SURVEY.md").read_bytes()
    text = np.frombuffer((raw * (N // len(raw) + 1))[:N], np.uint8)
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), N // 64)
    noise = rng.integers(0, 256, N, dtype=np.uint8)
    rec = np.where(rng.random(N) < 0.05, noise, rec).astype(np.uint8)
    letters = np.frombuffer(b"abcdefgh", np.uint8)[rng.integers(0, 8, N)]
    return {"text": text, "records": rec, "letters": letters,
            "zeros": np.zeros(N, np.uint8),
            "random": rng.integers(0, 256, N, dtype=np.uint8)}


BATCHES = {
    "text_records": (("text", "records"), (N, N), (False, True)),
    "tail_chunks": (("text", "records"), (40000, 4095), (True, False)),
    "records_letters": (("records", "letters"), (N, 65535), (True, True)),
    "zeros_random": (("zeros", "random"), (N, N), (False, True)),
    # 60 bytes cost less in a static block, 200 letters in a dynamic one
    "short_chunks": (("text", "letters"), (60, 200), (True, False)),
}


def _batch(kind):
    names, lengths, bfinal = BATCHES[kind]
    chunks = _chunks()
    return (np.stack([chunks[k] for k in names]),
            np.asarray(lengths, np.int32), np.asarray(bfinal))


def _check(bufs, lengths, words, total_bits, w_j, t_j):
    w_j, t_j = np.asarray(w_j), np.asarray(t_j)
    words = words.numpy().view(np.uint32)
    assert np.array_equal(total_bits.numpy(), t_j)
    assert np.array_equal(words, w_j)
    for k in range(bufs.shape[0]):
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()


@functools.lru_cache(maxsize=None)
def _port(tier, kind):
    bufs, lengths, bfinal = _batch(kind)
    return PORT[tier](bufs, lengths, bfinal, device="cpu")


@pytest.mark.parametrize("kind", list(BATCHES))
@pytest.mark.parametrize("tier", list(PORT))
def test_tier_matches_jax_xla(tier, kind):
    bufs, lengths, bfinal = _batch(kind)
    want = JAX[tier](jnp.asarray(bufs), jnp.asarray(lengths),
                     jnp.asarray(bfinal))
    _check(bufs, lengths, *_port(tier, kind), *want)


@pytest.mark.parametrize("tier", list(PALLAS))
def test_tier_matches_jax_pallas_interpret(tier):
    bufs, lengths, bfinal = _batch("tail_chunks")
    want = PALLAS[tier](jnp.asarray(bufs), jnp.asarray(lengths),
                        jnp.asarray(bfinal), interpret=True)
    _check(bufs, lengths, *_port(tier, "tail_chunks"), *want)


def test_dyn1_two_wide_segments():
    rng = np.random.default_rng(0x1E35A7BD)
    n = 1 << 18
    piece = rng.integers(0, 256, size=50000, dtype=np.uint8).tobytes()
    data = (piece + rng.integers(97, 123, size=30000, dtype=np.uint8)
            .tobytes() + piece
            + b"the quick brown fox jumps over the lazy dog. " * 3000)[:n]
    bufs = np.frombuffer(data, np.uint8)[None, :].copy()
    lengths, bfinal = np.array([n], np.int32), np.ones(1, bool)
    want = td.compress_chunks_dynamic(jnp.asarray(bufs),
                                      jnp.asarray(lengths),
                                      jnp.asarray(bfinal))
    _check(bufs, lengths, *lt.compress_chunks_dynamic(
        bufs, lengths, bfinal, device="cpu"), *want)


def test_stage_marks_and_block_choice():
    marks = []
    bufs, lengths, bfinal = _batch("zeros_random")
    lt.compress_chunks_dynamic3(bufs, lengths, bfinal, device="cpu",
                                on_stage=marks.append)
    assert marks == ["candidates", "commit", "emit_pre", "premerge", "pack",
                     "post", "end"]
    marks.clear()
    lt.compress_chunks_static(bufs, lengths, bfinal, device="cpu",
                              on_stage=marks.append)
    assert marks == ["candidates", "commit", "emit_pre", "premerge", "pack",
                     "post", "end"]
    # the first block's BTYPE: static (01) for 60 bytes, dynamic (10) for
    # 200 letters
    for tier in ("dyn1", "dyn2", "dyn3"):
        words, _ = _port(tier, "short_chunks")
        assert [int(words[k, 0]) & 7 for k in (0, 1)] == [0b010, 0b100]


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        return
    bufs, lengths, bfinal = _batch("text_records")
    for fn in PORT.values():
        with pytest.raises(RuntimeError):
            fn(bufs, lengths, bfinal)


def _hist_cases():
    rng = np.random.default_rng(5)
    cases = {
        "all equal": np.full(pd.NSYM, 7),
        "two symbols": np.eye(1, pd.NSYM, 3)[0] * 1000
        + np.eye(1, pd.NSYM, 200)[0],
        "286 used": rng.integers(1, 5000, pd.NSYM),
        # halving counts force the longest codes, past 11 bits
        "geometric": (1 << np.clip(20 - np.arange(pd.NSYM), 0, 20))
        * (np.arange(pd.NSYM) < 40),
        # nine count values over 286 symbols: ties at every level, and
        # the refinement's moves depend on taking the first index of a tie
        "ties": np.random.default_rng(28).choice(
            [1, 2, 3, 5, 6, 12, 24, 100, 300], pd.NSYM),
    }
    return {k: v.astype(np.int64) for k, v in cases.items()}


@pytest.mark.parametrize("case", list(_hist_cases()))
def test_build_code_lens_refined_15_bits(case):
    hist = _hist_cases()[case]
    lens_j, ok_j = jax.jit(functools.partial(
        td._build_code_lens, nsym=pd.NSYM, refine_passes=16,
        max_len=pd.MAX_CODE_LEN_DEEP))(jnp.asarray(hist, jnp.int32))
    lens, ok = scan_kernels.build_code_lens(torch.from_numpy(hist)[None], 16,
                                  pd.MAX_CODE_LEN_DEEP)
    assert np.array_equal(lens[0].numpy(), np.asarray(lens_j))
    assert bool(ok[0]) == bool(ok_j)
    if case == "geometric":
        assert int(lens.max()) > scan_kernels.MAX_CODE_LEN
