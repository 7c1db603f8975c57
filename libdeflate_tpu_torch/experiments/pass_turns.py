"""Compress passes of two trees of this repository on one card, in turns.

On a machine with a CUDA card, from the repository root:

    python3 -m libdeflate_tpu_torch.experiments.pass_turns \\
        [--against DIR] [--tiers lean,dyn2,optfast,dyn1,static,optimal]
        [--mesh 1,6 [--shards 1,2,4]]

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
count).  ``--tiers ""`` times no tier.  ``--mesh LEVELS`` also times the
whole file: ``gzip_compress_dp`` of the corpus (B = 16 x 1 MiB) at each
level over ``make_chunk_mesh(["cuda:0"] * k)`` for each k of
``--shards`` (1, 2 and 4 by default), three warm-up calls (a process's
first calls through new shard threads run slower) and the best of 3
(host clock, ending in ``torch.cuda.synchronize()``), each call's bytes
held to the SHA-256 pins of ``experiments/file_codec_pins.json``; then a
``device_trace`` of one call at the last level and the largest k: the
idle share, the streams that ran kernels and the ms in which two or
more of them had a kernel running (``stream_overlap``); and the host's
cost of issuing small CUDA ops from k threads at once beside the same
ops in turn (``host_threads``).  A tree whose mesh runs its shards in
turn (before shards ran at once) gives the in-turn times.  With
``--against`` the turns are DIR, this tree, this tree, DIR; without it,
this tree once.  Each turn prints one JSON line; the last line holds
them all with the card's name and power limit.

``trace_summary`` and ``stream_overlap`` read a Chrome trace of
``torch.profiler``; the turns and ``chip_smoke.py`` share them.
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
         "static": ("compress.pipeline", "compress_chunks_static"),
         "optimal": ("compress.optimal", "compress_chunks_optimal")}
WARM_CALLS = 3         # whole-file calls before the timed ones
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


def stream_overlap(trace_file: Path) -> dict:
    """The streams of a Chrome trace of ``torch.profiler`` that ran
    kernels: {"streams": their count, "busy_ms": each one's busy ms,
    "overlap_ms": the ms in which two or more had a kernel running}."""
    spans: dict = {}
    for e in json.loads(trace_file.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e:
            s = float(e["ts"])
            spans.setdefault(e["args"]["stream"], []).append(
                (s, s + float(e["dur"])))
    edges, busy = [], {}
    for stream, ivs in spans.items():
        ivs.sort()
        merged = [list(ivs[0])]
        for s, e in ivs[1:]:
            if s > merged[-1][1]:
                merged.append([s, e])
            else:
                merged[-1][1] = max(merged[-1][1], e)
        busy[str(stream)] = sum(e - s for s, e in merged) / 1e3
        edges += [(s, 1) for s, _ in merged] + [(e, -1) for _, e in merged]
    edges.sort(key=lambda x: (x[0], x[1]))
    overlap, running, last = 0.0, 0, None
    for t, step in edges:
        if running >= 2:
            overlap += t - last
        running += step
        last = t
    return {"streams": len(spans), "busy_ms": busy,
            "overlap_ms": overlap / 1e3}


def host_threads(counts=(1, 2, 4), ops: int = 2000) -> dict:
    """Host seconds to issue ``ops`` small CUDA ops (x + 1 on 1024
    int32) from each of k threads at once, each on a stream of its own,
    beside the same k * ops issued in turn from one thread, for each k
    of ``counts`` (the GIL's cost of shards at once on this host)."""
    import threading

    import torch

    dev = torch.device("cuda", torch.cuda.current_device())

    def issue(stream):
        x = torch.zeros(1024, dtype=torch.int32, device=dev)
        with torch.cuda.stream(stream):
            for _ in range(ops):
                x = x + 1

    out = {}
    for k in counts:
        streams = [torch.cuda.Stream(dev) for _ in range(k)]
        issue(streams[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for st in streams:
            issue(st)
        torch.cuda.synchronize()
        in_turn = time.perf_counter() - t0
        threads = [threading.Thread(target=issue, args=(st,))
                   for st in streams]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        out[str(k)] = {"at_once_s": time.perf_counter() - t0,
                       "in_turn_s": in_turn}
    return out


def mesh_turn(tree: Path, corpus: bytes, levels, shards) -> dict:
    """The whole-file times of ``tree``'s mesh at each level and shard
    count, and one traced call (see the module's docstring)."""
    import hashlib
    import tempfile

    import torch
    from libdeflate_tpu_torch.parallel import file_codec, mesh
    from libdeflate_tpu_torch.utils.profiling import device_trace
    pins = json.loads((tree / "libdeflate_tpu_torch" / "experiments" /
                       "file_codec_pins.json").read_text())["gzip"]
    out = {}
    for level in levels:
        for k in shards:
            m = mesh.make_chunk_mesh(["cuda:0"] * k)

            def call():
                res = file_codec.gzip_compress_dp(corpus, m, 1 << 20, level)
                torch.cuda.synchronize()
                return res

            for _ in range(WARM_CALLS):
                got = call()
            if hashlib.sha256(got).hexdigest() != pins[str(level)]["sha256"]:
                raise AssertionError(f"level {level}, {k} shards: the bytes "
                                     f"differ from the pin")
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                call()
                secs.append(time.perf_counter() - t0)
            out[f"level {level}, {k} shards"] = {"best_s": min(secs),
                                                 "s": secs}
    m = mesh.make_chunk_mesh(["cuda:0"] * shards[-1])
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(str(Path(tmp) / "trace")):
            file_codec.gzip_compress_dp(corpus, m, 1 << 20, levels[-1])
            torch.cuda.synchronize()
        (trace_file,) = (Path(tmp) / "trace").glob("trace_*.json")
        _, idle, window_ms, n_ops = trace_summary(trace_file)
        out["trace"] = {"level": levels[-1], "shards": shards[-1],
                        "idle": idle, "window_ms": window_ms,
                        "device_ops": n_ops, **stream_overlap(trace_file)}
    out["host_threads"] = host_threads(shards)
    return out


def one_turn(tree: Path, tiers: list[str], levels=(), shards=()) -> dict:
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
    if levels:
        out["mesh"] = mesh_turn(tree, corpus, levels, shards)
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
    tiers = ([t for t in argv[argv.index("--tiers") + 1].split(",") if t]
             if "--tiers" in argv else list(TIERS))
    levels = ([int(x) for x in argv[argv.index("--mesh") + 1].split(",")
               if x] if "--mesh" in argv else [])
    shards = ([int(x) for x in argv[argv.index("--shards") + 1].split(",")]
              if "--shards" in argv else [1, 2, 4])
    if "--one" in argv:
        tree = Path(argv[argv.index("--one") + 1])
        print(json.dumps(one_turn(tree, tiers, levels, shards)), flush=True)
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
             ",".join(tiers), "--mesh", ",".join(map(str, levels)),
             "--shards", ",".join(map(str, shards))],
            capture_output=True, text=True, timeout=900)
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
