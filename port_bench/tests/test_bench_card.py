"""On the card: each one-card cell runs a short window through the
command line and comes out correct, on the card it names."""

import json
import subprocess
import sys

import pytest

from port_bench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, name, trace):
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        name, "--seed", "4000000007", "--seconds", "2",
                        "--trace", str(trace)], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == 1 and r["metrics"]
