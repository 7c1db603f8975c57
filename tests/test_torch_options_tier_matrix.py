"""``experiments/tier_matrix.py`` against ``scripts/tier_matrix.py``.

The port's configuration table, name for name, against the
``functools.partial`` keywords of the script's ``tier_configs()`` (the
same names in the same order; each configuration but "leanfinal"
``compress_chunks_optimal_pallas_with`` with the keywords the script
gives ``_compress_chunks_optimal_pallas``, "leanfinal" the lean entry
where the script has ``compress_chunks_lean_pallas``).  And the driver's
loop on the CPU at a small size: one configuration over two batches of
two 16 KiB chunks prints its GB/s, ratio and OK; a name filter; the
command line with ``--device cpu``.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from dp_tier_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu_torch.experiments import tier_matrix

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def script_configs():
    """scripts/tier_matrix.py's tier_configs(), run with no arguments."""
    argv = sys.argv
    sys.argv = ["tier_matrix.py"]
    try:
        sys.path.insert(0, str(REPO))
        spec = importlib.util.spec_from_file_location(
            "scripts_tier_matrix", REPO / "scripts" / "tier_matrix.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.tier_configs(), mod
    finally:
        sys.argv = argv


def test_same_names_in_the_same_order():
    assert list(tier_matrix.CONFIGS) == list(script_configs()[0])
    assert list(tier_matrix.tier_configs()) == list(tier_matrix.CONFIGS)


@pytest.mark.parametrize("name", list(tier_matrix.CONFIGS))
def test_same_keywords(name):
    want, mod = script_configs()
    got = tier_matrix.tier_configs()[name]
    if name == "leanfinal":
        assert want[name] is mod.to.compress_chunks_lean_pallas
        assert got is lt.compress_chunks_lean
        return
    assert want[name].func is mod.to._compress_chunks_optimal_pallas
    assert got.func is lt.compress_chunks_optimal_pallas_with
    assert got.keywords == want[name].keywords
    assert got.keywords == tier_matrix.CONFIGS[name]


def test_run_config_on_the_cpu(capsys):
    n = 1 << 14
    raw = (REPO / "SURVEY.md").read_bytes()
    bufs_np = np.frombuffer((raw * (4 * n // len(raw) + 1))[:4 * n],
                            np.uint8).reshape(4, n)
    batches = [(torch.from_numpy(bufs_np[i:i + 2].copy()),
                torch.full((2,), n), torch.zeros(2, dtype=torch.bool))
               for i in (0, 2)]
    name = "lean1X8(p1,rawC,lcp8)"
    fn = tier_matrix.tier_configs([name])[name]
    assert tier_matrix.run_config(name, fn, bufs_np, batches,
                                  torch.device("cpu"))
    line = capsys.readouterr().out.strip()
    assert line.startswith(name) and " GB/s  ratio 0." in line \
        and line.endswith("OK")
    assert list(tier_matrix.tier_configs(["lean1X"])) == [
        "lean1X(p1,rawC)", "lean1XF(p1,rawC,flat)", "lean1XR(p1,rawC,rowlit)",
        "lean1X8(p1,rawC,lcp8)", "lean1XR8(rawC,rowlit,lcp8)"]


def test_main_with_no_matching_name(capsys):
    assert tier_matrix.main(["--device", "cpu", "--batch", "8",
                             "no-such-configuration"]) == 0
    assert capsys.readouterr().out == "batch=8, 2 batches x 8 chunks\n"
