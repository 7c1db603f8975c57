"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract's shape."""

import importlib
import json
import re

import pytest

from port_bench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(name):
    cell, cfg, mix = run.resolve(BENCH, name)
    assert cfg["name"] == cell["config"]
    kind = importlib.import_module(f"port_bench.traffic.{mix['kind']}")
    assert hasattr(kind.Cell, "call") and hasattr(kind.Cell, "judge")
    assert cfg["cards"] == cell["chips"]
    for m in BENCH["per_layer"]:
        if run.applies(m, name):
            assert callable(run.metric_reader(m["name"]))
    assert any(run.applies(m, name) for m in BENCH["per_layer"])
    e2e = [m["name"] for m in BENCH["end_to_end"] if run.applies(m, name)]
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_end_to_end_metrics_come_from_the_kind(name):
    _, _, mix = run.resolve(BENCH, name)
    kind = importlib.import_module(f"port_bench.traffic.{mix['kind']}")
    calls = [(0.0, 0.5, 1 << 20, 1 << 19), (0.5, 1.2, 1 << 20, 1 << 19)]
    got = kind.Cell.end_to_end(calls, 0.0)
    for m in BENCH["end_to_end"]:
        if run.applies(m, name) and m["name"] != "setup_s":
            assert got[m["name"]] > 0


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, cells // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_a_full_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_are_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"whole-file entry and codec", "mesh",
                      "tier entries and device checksums", "kernels",
                      "device"}
