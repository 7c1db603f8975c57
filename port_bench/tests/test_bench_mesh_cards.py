"""The four-card cell's readers on synthetic profiler events, and on the
cards a short run of the cell.

- ``peer_copy_ms.compress``: a copy between two cards (the profiler's
  ``Memcpy PtoP``) counts, a copy within one card does not; device ops
  and no peer copy read 0, no device op None.
- ``card_copy_idle_ms.compress``: idle inside ``mesh.card_in`` or
  ``mesh.card_out`` counts, idle inside ``codec.pad`` does not; a trace
  without either span reads None.
- On a host of four cards: the cell ``gzip6-1MiB-4card.compress-256MiB``
  through the command line, untraced and traced, comes out correct on
  four cards (skipped with fewer).
"""

import json
import subprocess
import sys
import types

import pytest
import torch

from port_bench import run
from port_bench.trace import CALL_SPAN, Ev, Traced

MS = 1_000_000  # ns
CELL = "gzip6-1MiB-4card.compress-256MiB"


def ev(name, kind, start_ms, end_ms, device=0, thread=1):
    if kind in ("kernel", "memcpy", "memset"):
        return Ev(name, kind, device, 7, int(start_ms * MS), int(end_ms * MS))
    return Ev(name, kind, -1, thread, int(start_ms * MS), int(end_ms * MS))


def read(name, events, devices=(0, 1)):
    t = Traced(events, list(devices))
    return run.metric_reader(name)(t, types.SimpleNamespace(chunk=1 << 20))


CALLS = [ev(CALL_SPAN, "span", 0, 100), ev(CALL_SPAN, "span", 100, 200)]


def test_a_copy_between_cards_counts_and_one_within_a_card_does_not():
    events = CALLS + [
        ev("Memcpy PtoP (Device -> Device)", "memcpy", 10, 13, device=1),
        ev("Memcpy PtoP (Device -> Device)", "memcpy", 110, 111, device=2),
        ev("Memcpy DtoD (Device -> Device)", "memcpy", 20, 40),
        ev("Memcpy HtoD (Pinned -> Device)", "memcpy", 50, 60, device=1),
        ev("k", "kernel", 60, 90)]
    assert read("peer_copy_ms.compress", events) == pytest.approx(4 / 2)


def test_no_peer_copy_reads_zero_and_no_device_op_none():
    within = CALLS + [ev("Memcpy DtoD (Device -> Device)", "memcpy", 5, 9),
                      ev("k", "kernel", 10, 20, device=1)]
    assert read("peer_copy_ms.compress", within) == 0
    assert read("peer_copy_ms.compress", CALLS + [
        ev("aten::to", "cpu", 5, 9)]) is None


def test_idle_in_the_card_copies_counts_and_idle_in_pad_does_not():
    events = CALLS + [
        # the card busy 0-10, 30-60, 70-100 and 100-195
        ev("k", "kernel", 0, 10), ev("c", "memcpy", 30, 60),
        ev("k", "kernel", 70, 100, device=1), ev("k", "kernel", 100, 195),
        ev("codec.pad", "span", 10, 20),                  # idle 10-20
        ev("mesh.inputs", "span", 20, 30),
        ev("mesh.card_in", "span", 22, 26),               # idle 22-26
        ev("mesh.card_in", "span", 26, 29),               # idle 26-29
        ev("codec.to_host", "span", 60, 70),
        ev("mesh.card_out", "span", 62, 68),              # idle 62-68
        ev("codec.to_host", "span", 195, 200),
        ev("mesh.card_out", "span", 196, 199)]            # idle 196-199
    assert read("card_copy_idle_ms.compress", events) == pytest.approx(
        (4 + 3 + 6 + 3) / 2)
    assert read("entry_idle_ms.compress", events) == pytest.approx(
        (10 + 10 + 10 + 5) / 2)


def test_a_trace_without_the_card_spans_reads_none():
    events = CALLS + [ev("k", "kernel", 0, 10), ev("codec.pad", "span", 10,
                                                   20)]
    assert read("card_copy_idle_ms.compress", events) is None
    assert read("entry_idle_ms.compress", events) == pytest.approx(10 / 2)


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_four_cards(card, trace):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"{CELL} needs four CUDA cards; found "
                    f"{torch.cuda.device_count()}")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        CELL, "--seed", "4000000009", "--seconds", "2",
                        "--trace", str(trace)], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == 4 and r["metrics"]
    assert r["checks"]["wrong_members"]["value"] == 0
    assert r["checks"]["over_bound_members"]["value"] == 0
    if trace:
        assert r["metrics"]["peer_copy_ms.compress"]["value"] == 0
