"""The port's device measurement path as a whole, on the CPU.

libdeflate_tpu_torch/experiments/exp_device_roundup.py::main with
device="cpu" at a small size (8 chunks of 64 KiB): every section but 3
(1, 2, 4, 5, tok, overhead) runs through the plain versions and every result
is right; section 3 (the DP tiers opt and optD) runs alone on 4 chunks of
2 KiB; a section the script does not have raises.  Section 2's and 3's
ratios against the port's dyn1, dyn2, optimal and deep entries, and the
overhead script's dyn1
baseline against the JAX package's compress_chunks_dynamic at B = 2 x 16
KiB.  The corpus recipe
(experiments/corpus.py) against bench.make_corpus with the same text, the
per-class streams against the corpus spans of
scripts/exp_tokenize_ceiling.py::class_streams, and the port's K4 on a whole
class against the script's tokenize_chunks in interpret mode.  The CLI
entries of the ceiling and overhead scripts run with --cpu.

Tolerance: exact.
"""

import glob
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libdeflate_tpu_torch.decompress.decode import pack_streams
from libdeflate_tpu_torch.experiments import corpus as pc
from libdeflate_tpu_torch.experiments import exp_device_roundup as rd
from libdeflate_tpu_torch.experiments import exp_launch_overhead as lo
from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk
from scripts import exp_tokenize_ceiling as ref

TOTAL, CHUNK = 8 << 16, 1 << 16
# section 3 times the DP tiers five times over the corpus: it runs alone,
# on four 2 KiB chunks (test_roundup_times_the_dp_tiers)
SECTIONS = [s for s in rd.SECTIONS if s != "3"]


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


@pytest.fixture(scope="module")
def roundup():
    for mod in (rd, lo, tk):
        mod.reset_launch_counts()
    return rd.main(SECTIONS, device="cpu", total=TOTAL, chunk=CHUNK)


def test_roundup_runs_every_ported_section_right(roundup):
    assert list(roundup) == SECTIONS
    assert rd.all_ok(roundup)
    assert sorted(roundup["1"]) == list(rd.PROBE_STEPS)
    assert sorted(roundup["4"]) == ["adler32", "crc32"]
    assert sorted(roundup["tok"]) == sorted(tk.CLASSES)
    for row in roundup["tok"].values():
        assert list(row) == [*tk.VARIANTS, "dec"]
    assert sorted(roundup["overhead"]["grid"]) == list(lo.STEP_COUNTS)
    # on the CPU nothing launches and no device time is claimed
    assert roundup["1"][1]["cuda_ms"] is None
    assert tk.tokenize_chunks.launches == 0
    assert lo.grid_add_one.launches == lo.loop_add_one.launches == 0
    assert rd.grid_copy.launches == 0


def test_roundup_sizes(roundup):
    assert roundup["tok"]["mixed"]["tok1"]["bytes"] == TOTAL
    assert roundup["tok"]["runs"]["dec"]["bytes"] == TOTAL // 8
    assert roundup["5"]["ok"] and roundup["4"]["crc32"]["ok"]


@pytest.mark.parametrize("section", ["0", "7"])
def test_sections_not_ported_raise(section):
    with pytest.raises(ValueError):
        rd.main([section], device="cpu", total=TOTAL, chunk=CHUNK)


def test_corpus_recipe_matches_bench(monkeypatch, tmp_path):
    """With the same text (bench's fallback text, used when its glob of
    reference files finds none), the port's corpus is bench.make_corpus
    byte for byte."""
    monkeypatch.setattr(glob, "glob", lambda *a, **k: [])
    (tmp_path / "SURVEY.md").write_bytes(b"fallback text " * 1000)
    (tmp_path / "PERF_NOTES.md").write_bytes(b"")
    assert pc.make_corpus(1 << 20, tmp_path) == bench.make_corpus(1)


@pytest.mark.parametrize("cls", pc.CLASSES)
def test_class_streams_cut_the_spans(cls):
    corpus = pc.make_corpus(TOTAL)
    chunks, streams = pc.class_streams(cls, TOTAL, CHUNK, corpus)
    u = TOTAL // 8
    lo_, hi = {"text": (0, 2), "skew": (2, 4), "recs": (4, 6),
               "rand": (6, 7), "runs": (7, 8), "mixed": (0, 8)}[cls]
    assert b"".join(chunks) == corpus[lo_ * u:hi * u]
    assert all(len(c) == CHUNK for c in chunks)
    for c, s in zip(chunks, streams):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        assert s == co.compress(c) + co.flush()


def test_a_whole_class_matches_the_script():
    chunks, streams = pc.class_streams("mixed", TOTAL, CHUNK)
    comp, clen = pack_streams(streams)
    olen = np.array([len(c) for c in chunks], np.int32)
    want = ref.tokenize_chunks(jnp.asarray(comp), jnp.asarray(clen),
                               jnp.asarray(olen), interpret=True)
    got = tk.tokenize_chunks(comp, clen, olen, device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0].tolist() == [0] * len(chunks)
    assert got[1].tolist() == olen.tolist()


def test_cli_entries_on_the_cpu(capsys):
    assert lo.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain versions" in out and "grid= 256" in out
    assert tk.main(["--cpu", "--cls", "runs", "tok1"]) == 0
    out = capsys.readouterr().out
    assert "runs" in out and "tok1=" in out and "K3 dec=" in out


def test_roundup_times_the_dynamic_tiers(roundup):
    """Section 2 on the CPU: dyn1 and dyn2 over the corpus, every chunk
    through zlib, and the ratio that the port's own entries give."""
    import libdeflate_tpu_torch as lt
    assert sorted(roundup["2"]) == ["dyn1", "dyn2"]
    bufs = np.frombuffer(pc.make_corpus(TOTAL), np.uint8).reshape(-1, CHUNK)
    for name, fn in (("dyn1", lt.compress_chunks_dynamic),
                     ("dyn2", lt.compress_chunks_dynamic2)):
        row = roundup["2"][name]
        assert row["ok"]
        _, bits = fn(bufs, np.full(len(bufs), CHUNK), np.zeros(len(bufs),
                                                               bool),
                     device="cpu")
        assert row["ratio"] == int(((bits + 7) // 8).sum()) / TOTAL


def test_dynamic_baseline_matches_jax():
    """The launch script's dyn1 baseline at B = 2 x 16 KiB: the same
    total_bits as the JAX package's compress_chunks_dynamic on the same
    bytes."""
    from libdeflate_tpu.compress import tpu_dynamic as td
    res = lo.dynamic_baseline("cpu", batch=2, n=1 << 14)
    data = np.random.default_rng(0).integers(0, 64, (2, 1 << 14), np.uint8)
    _, want = td.compress_chunks_dynamic(
        jnp.asarray(data), jnp.full(2, 1 << 14, jnp.int32),
        jnp.zeros(2, bool))
    assert res["total_bits"] == np.asarray(want).tolist()
    assert res["ms"] > 0 and res["mb_s"] > 0


def test_roundup_times_the_dp_tiers():
    """Section 3 on the CPU at 4 x 2 KiB (one call a pass): opt and optD
    over the corpus, every chunk through zlib, and the ratio that the
    port's own optimal and deep entries give."""
    import libdeflate_tpu_torch as lt
    total, chunk = 4 << 11, 1 << 11
    res = rd.main(["3"], device="cpu", total=total, chunk=chunk)
    assert list(res) == ["3"] and rd.all_ok(res)
    assert sorted(res["3"]) == ["opt", "optD"]
    bufs = np.frombuffer(pc.make_corpus(total), np.uint8).reshape(-1, chunk)
    for name, fn in (("opt", lt.compress_chunks_optimal),
                     ("optD", lt.compress_chunks_optimal_deep)):
        _, bits = fn(bufs, np.full(len(bufs), chunk),
                     np.zeros(len(bufs), bool), device="cpu")
        assert res["3"][name]["ratio"] == int(((bits + 7) // 8).sum()) / total
