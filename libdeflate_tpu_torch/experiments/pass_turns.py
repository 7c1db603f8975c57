"""Compress passes of two trees of this repository on one card, in turns.

On a machine with a CUDA card, from the repository root:

    python3 -m libdeflate_tpu_torch.experiments.pass_turns \\
        [--against DIR] [--tiers lean,dyn2,optfast,dyn1,static]

Each turn is a process of its own that imports ``libdeflate_tpu_torch``
from one tree (DIR, an earlier checkout such as ``git archive`` of the
parent commit, unpacked where ``.gitignore`` lists it; or this tree),
builds that tree's kernels, makes the 16 MiB corpus
(``experiments/corpus.py``) and, for each tier, calls its entry on the
four B = 4 x 1 MiB batches: one warm-up pass, the best of 3 timed
passes (host clock, ending in ``torch.cuda.synchronize()``), one pass
by stage (CUDA events at the entry's ``on_stage`` marks), then a
``utils.profiling.device_trace`` of one ``compress_chunks_lean`` call
(the device's idle share over the traced window and its device-op
count).  With ``--against`` the turns are DIR, this tree, this tree,
DIR; without it, this tree once.  Each turn prints one JSON line; the
last line holds them all with the card's name and power limit.

``trace_summary`` reads a Chrome trace of ``torch.profiler``; the turns
and ``chip_smoke.py`` share it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

TIERS = {"lean": ("compress.optimal", "compress_chunks_lean"),
         "dyn2": ("compress.dynamic", "compress_chunks_dynamic2"),
         "optfast": ("compress.optimal", "compress_chunks_optfast"),
         "dyn1": ("compress.dynamic", "compress_chunks_dynamic"),
         "static": ("compress.pipeline", "compress_chunks_static")}
HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]


def trace_summary(trace_file: Path, top: int = 15):
    """(the ``top`` device ops by self time, as [name, ms, count], the
    device's idle share, the window in ms and the count of device ops) of
    a Chrome trace written by ``torch.profiler``: the idle share is the
    share of the traced window (first event's start to last event's end,
    host and device) in which no kernel, copy or memset ran."""
    events = [e for e in json.loads(trace_file.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events if e.get("cat") in dev_cats)
    if not dev:
        raise AssertionError("the trace holds no device op")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict[str, list] = {}
    for s, e, name in dev:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e3
        row[1] += 1
    ops = sorted(([n[:80], round(ms, 6), c] for n, (ms, c) in by_name.items()),
                 key=lambda r: -r[1])[:top]
    return ops, 1 - busy / (end - start), (end - start) / 1e3, len(dev)


def one_turn(tree: Path, tiers: list[str]) -> dict:
    """This process's turn: the package of ``tree`` on the card."""
    import importlib
    import tempfile

    import numpy as np
    import torch
    sys.path.insert(0, str(tree))
    from libdeflate_tpu_torch import _build
    from libdeflate_tpu_torch.experiments.corpus import make_corpus
    from libdeflate_tpu_torch.utils.profiling import device_trace
    if not torch.cuda.is_available():
        raise SystemExit("pass_turns: no CUDA device")
    _build.build()
    dev = torch.device("cuda")
    corpus = make_corpus(16 << 20, tree)
    chunks = np.frombuffer(corpus, np.uint8).reshape(16, 1 << 20)
    batches = [torch.as_tensor(chunks[i:i + 4].copy(), device=dev)
               for i in range(0, 16, 4)]
    lengths = torch.full((4,), 1 << 20, dtype=torch.int64, device=dev)
    bfinal = torch.ones(4, dtype=torch.bool, device=dev)
    out = {"tree": str(tree)}
    for tier in tiers:
        mod, fn = TIERS[tier]
        entry = getattr(importlib.import_module(
            f"libdeflate_tpu_torch.{mod}"), fn)

        def one_pass(**kw):
            for b in batches:
                entry(b, lengths, bfinal, **kw)
            torch.cuda.synchronize()

        one_pass()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            one_pass()
            secs.append(time.perf_counter() - t0)
        marks = []

        def on_stage(name):
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        one_pass(on_stage=on_stage)
        stages: dict[str, float] = {}
        for (name, ev), (_, nxt) in zip(marks, marks[1:]):
            if name != "end":           # a call's end to the next's start
                stages[name] = stages.get(name, 0.0) + ev.elapsed_time(nxt)
        out[tier] = {"best_s": min(secs), "s": secs, "stage_ms": stages}
    lean = importlib.import_module(
        "libdeflate_tpu_torch.compress.optimal").compress_chunks_lean
    lean(batches[0], lengths, bfinal)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(str(Path(tmp) / "trace")):
            lean(batches[0], lengths, bfinal)
            torch.cuda.synchronize()
        (trace_file,) = (Path(tmp) / "trace").glob("trace_*.json")
        ops, idle, window_ms, n_ops = trace_summary(trace_file)
    out["lean_trace"] = {"idle": idle, "window_ms": window_ms,
                         "device_ops": n_ops, "top": ops[:5]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tiers = (argv[argv.index("--tiers") + 1].split(",")
             if "--tiers" in argv else list(TIERS))
    if "--one" in argv:
        tree = Path(argv[argv.index("--one") + 1])
        print(json.dumps(one_turn(tree, tiers)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("pass_turns: no CUDA device", file=sys.stderr)
        return 1
    trees = [ROOT]
    if "--against" in argv:
        other = Path(argv[argv.index("--against") + 1]).resolve()
        trees = [other, ROOT, ROOT, other]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    turns = []
    for tree in trees:
        res = subprocess.run(
            [sys.executable, str(HERE), "--one", str(tree), "--tiers",
             ",".join(tiers)], capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"pass_turns: the turn of {tree} failed")
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
