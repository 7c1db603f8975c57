"""The ported measurement and ratio drivers of ``scripts/``
(``libdeflate_tpu_torch/experiments/``): the second corpus and its class
spans against ``bench.py`` and the scripts, the drivers' tables against
the scripts', and every driver's ``main`` on the CPU at a tiny size.

- ``corpus.make_corpus2`` is ``bench.make_corpus2`` byte for byte at
  16 MiB, with bench's ``glob.glob`` giving ``native/ldtpu_native.cpp``
  for its C sources (the port's text part) and nothing for its headers.
- The class spans (``corpus1_classes``, ``corpus2_classes``) are
  ``scripts/exp_corpus2_breadth.py``'s, and ``match_bias_sets`` cuts
  ``scripts/exp_match_bias.py``'s three sets; both scripts' code taken
  by ``ast`` (importing them runs JAX on the card's relay).
- ``exp_corpus2_breadth.VARIANTS`` are the script's ``variants()``
  keywords.
- Each driver's ``main`` with ``--device cpu`` (the plain versions) at a
  tiny size returns 0 and prints the lines its script prints, each of
  which parses; without ``--device`` every driver raises here (no CUDA).

Tolerance: exact.
"""

import glob
import re

import numpy as np
import pytest
import torch

import bench
import driver_cases as dc
from libdeflate_tpu_torch.experiments import (ablate_lean, corpus,
                                              exp_checksum_decode,
                                              exp_corpus2_breadth,
                                              exp_crc_profile, exp_dp_corpus,
                                              exp_match_bias, exp_r5_speed,
                                              exp_ratio_gap,
                                              exp_text_gap_diag, probe_prims,
                                              profile_lean, profile_opt,
                                              ratio_ab)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_make_corpus2_is_bench(monkeypatch):
    text = str(corpus.REPO / corpus.TEXT2)
    monkeypatch.setattr(glob, "glob", lambda pattern, recursive=False:
                        [text] if pattern.endswith("*.c") else [])
    want = bench.make_corpus2(16)
    assert corpus.make_corpus2(16 << 20) == want
    assert len(want) == 16777197


def test_class_spans_are_the_scripts():
    ns = dc.script_defs("exp_corpus2_breadth.py",
                        ("corpus1_classes", "corpus2_classes"), {})
    assert corpus.corpus1_classes(16 << 20) == ns["corpus1_classes"](16)
    assert corpus.corpus2_classes(16 << 20) == ns["corpus2_classes"](16)
    c1, c2 = corpus.make_corpus(1 << 20), corpus.make_corpus2(1 << 20)
    sets = dc.main_defs("exp_match_bias.py", ("u2", "sets"),
                        {"corp1": c1, "corp2": c2})["sets"]
    assert corpus.match_bias_sets(c1, c2) == sets


def test_corpus2_breadth_variants_are_the_scripts():
    assert list(exp_corpus2_breadth.VARIANTS) == list(dc.CORPUS2_VARIANTS)
    for name, fn in dc.CORPUS2_VARIANTS.items():
        want = {k: tuple(v) if isinstance(v, (tuple, list)) else v
                for k, v in fn.keywords.items()}
        got = {k: tuple(v) if isinstance(v, (tuple, list)) else v
               for k, v in exp_corpus2_breadth.options(name).items()}
        assert got == want, name


TINY = ["--device", "cpu", "--total", "4096", "--chunk", "512"]
NUM = r"[-+]?\d+(\.\d+)?"
# driver -> (argv, a pattern every line after the header matches, lines)
MAINS = {
    "profile_lean": (profile_lean, ["--device", "cpu", "--batch", "2",
                                    "--chunk", "4096", "--reps", "1"],
                     rf"^.{{46}} host +{NUM} ms  events +not measured  "
                     rf"\( *{NUM} ms/chunk\)$", 18),
    "profile_opt": (profile_opt, ["--device", "cpu", "--batch", "2",
                                  "--chunk", "4096", "--reps", "1"],
                    rf"^.{{42}} host +{NUM} ms  events +not measured  "
                    rf"\( *{NUM} ms/chunk\)$", 21),
    "ablate_lean": (ablate_lean, ["--device", "cpu", "--total", "4096",
                                  "--chunk", "1024", "--passes", "1",
                                  "none", "cand"],
                    rf"^\w+ +{NUM} GB/s \( *{NUM} ms/batch\) "
                    rf"(OK|marginal +{NUM} ms/batch)$", 3),
    "probe_prims": (probe_prims, ["--device", "cpu", "--n", "131072",
                                  "--reps", "1"],
                    rf"^.{{52}} host +{NUM} ms  events not measured", 17),
    "ratio_ab": (ratio_ab, TINY + ["--sample", "base", "ext2none+"],
                 rf"^\S+ +ratio {NUM}  OK$", 4),
    "exp_match_bias": (exp_match_bias, ["--device", "cpu", "--total",
                                        "2048", "--chunk", "512"],
                       rf"^bias=\S+ +corpus1={NUM}%  c2-text={NUM}%  "
                       rf"c2-recs={NUM}%$", 10),
    "exp_corpus2_breadth": (exp_corpus2_breadth,
                            ["--device", "cpu", "--total", "10240",
                             "--chunk", "512", "--passes", "1", "--c2only",
                             "lean-d10"],
                            rf"^(|== corpus\d ==  zlib-6: .*|lean-d10 +{NUM}"
                            rf" MB/s  all={NUM}%  .*zlib-6\)|no libdeflate -6"
                            rf" reference ratios .*)$", 5),
    "exp_r5_speed": (exp_r5_speed, TINY + ["--passes", "1", "lean-s4",
                                           "dyn-lcp8-d4"],
                     rf"^\S+ +B=\d  {NUM} GB/s  ratio {NUM}%$", 3),
    "exp_dp_corpus": (exp_dp_corpus, TINY + ["--passes", "1"],
                      rf"^\w+ *: +{NUM} MB/s  ratio {NUM}%$", 4),
    "exp_ratio_gap": (exp_ratio_gap, TINY,
                      rf"^(.+: +{NUM} MB/s  ratio {NUM}%|L6 parse re-cost: "
                      rf"device-kraft {NUM}%  pm11 {NUM}%  pm15 {NUM}%|"
                      rf"\(header .*\))$", 6),
    "exp_text_gap_diag": (exp_text_gap_diag, ["1", "--device", "cpu",
                                              "--chunk", "4096"],
                          r"^(chunk 0: native \d+ B vs device \d+ B .*|"
                          r"  (native-L6|device-lean) +blocks=.*|"
                          r" +len3=\d+ .*)$", 6),
    "exp_checksum_decode": (exp_checksum_decode,
                            ["--device", "cpu", "--rows", "2", "--row-bytes",
                             "8192", "--chunks", "2", "--chunk", "4096"],
                            rf"^(CRC-32 |Adler32|K3 decode) +{NUM} [MG]B/s "
                            rf".*\(OK\)$", 4),
    "exp_crc_profile": (exp_crc_profile,
                        ["--device", "cpu", "--rows", "2", "--row-bytes",
                         "8192", "--k", "2"],
                        rf"^ *\S.{{0,35}} +{NUM} GB/s \(host {NUM} ms, "
                        rf"events not measured\)$", 7),
}


@pytest.mark.parametrize("name", MAINS)
def test_main_runs_on_the_cpu_and_its_lines_parse(name, capsys):
    mod, argv, pattern, n_lines = MAINS[name]
    assert mod.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == n_lines, lines
    body = lines[1:]
    assert all(re.match(pattern, ln) for ln in body), \
        [ln for ln in body if not re.match(pattern, ln)]


@pytest.mark.parametrize("name", MAINS)
def test_main_needs_cuda_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        return
    mod, argv, _, _ = MAINS[name]
    argv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError):
        mod.main(argv)


def test_ratio_gap_recost_equals_the_jax_pins():
    """``exp_ratio_gap.recost`` on the CPU (the plain commit and code
    lengths) on the second corpus's pinned text chunk equals the script's
    re-costing through the JAX package
    (``experiments/ratio_total_bits.json``; the card holds both pinned
    chunks)."""
    import json
    pins = json.loads((corpus.REPO / "libdeflate_tpu_torch" / "experiments"
                       / "ratio_total_bits.json").read_text())
    text = corpus.make_corpus2(corpus.CORPUS_BYTES)[:corpus.CHUNK]
    row = np.frombuffer(text, np.uint8)[None]
    assert exp_ratio_gap.recost(row, torch.device("cpu")) == \
        pins["ratio_gap_recost"]["c2-text"]


def test_text_gap_tokenizer_is_the_scripts():
    """The port's copy of the script's tokenizer gives the script's
    statistics on a native level-6 stream and on the lean tier's."""
    ns = dc.script_defs("exp_text_gap_diag.py",
                        ("LEN_BASE", "LEN_EXTRA", "OFF_BASE", "OFF_EXTRA",
                         "PERM", "_BR", "_mkdec", "_dsym", "tokenize",
                         "stream_stats"), {"np": np})
    chunk = corpus.make_corpus2(1 << 20)[:8192]
    for stream in (exp_text_gap_diag.Compressor(6).deflate_compress(chunk),
                   exp_text_gap_diag.lean_stream(chunk,
                                                 torch.device("cpu"))):
        assert exp_text_gap_diag.stream_stats(bytes(stream)) == \
            ns["stream_stats"](bytes(stream))
