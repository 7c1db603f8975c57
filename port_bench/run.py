"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``;
its configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, whose ``kind`` names the module
``traffic/<kind>.py`` that drives the program, and each per-layer metric
is read by ``metrics/<name>.py``.

A run makes its inputs from the seed, warms up on the cell's own shapes,
runs calls back to back for ``--seconds`` (the window ends with the call
that crosses it), judges every output after the window, and prints one
JSON line.  With ``--trace 1`` one profiler session covers a fixed
number of the window's calls, and the line carries the per-layer
metrics in place of the end-to-end ones.  The numbers compared come
last, on standard error and in the line's ``checks``.

Exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for, and 3 if a module of JAX or of the JAX package was
loaded.
"""

from __future__ import annotations

import os
import time


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - process_age()

import argparse                                          # noqa: E402
import contextlib                                        # noqa: E402
import importlib                                         # noqa: E402
import importlib.util                                    # noqa: E402
import json                                              # noqa: E402
import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "libdeflate_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workloads entry, its configuration, its traffic mix)."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT / cfg_entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, devices=None, system: str = "port", sizes=None) -> int:
    """One run; returns the exit code.  ``devices`` (tests) runs the
    port on those torch devices and skips the look for cards; ``system``
    "control" puts the cell's control in the program's place; ``sizes``
    (tests) overrides sizes of the configuration and the mix."""
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix = resolve(bench, args.workload)
    for key, value in (sizes or {}).items():
        (cfg if key in cfg else mix)[key] = value

    import torch
    on_card = devices is None
    if on_card:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"found {torch.cuda.device_count()}")
            return 2
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
        if system == "port":
            from libdeflate_tpu_torch import _build
            _build.build()
    kind = importlib.import_module(f"port_bench.traffic.{mix['kind']}")
    run = kind.Cell(cfg, mix, args.seed, devices, system)
    try:
        return finish(args, bench, mix, kind, run, devices)
    finally:
        run.close()


def finish(args, bench, mix, kind, run, devices) -> int:
    """Warm-up, the window, the judge and the result line of ``run``, a
    ``kind.Cell`` on ``devices``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    on_card = devices[0].type == "cuda"

    def sync():
        for d in devices if on_card else ():
            torch.cuda.synchronize(d)

    run.warmup()
    sync()
    start = time.perf_counter()
    setup_s = start - T0
    skip, ntrace = mix["trace"]["skip"], mix["trace"]["calls"]
    calls, events, prof = [], None, None
    i = 0
    while True:
        traced = args.trace and skip <= i < skip + ntrace
        if traced and prof is None:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        with record_function(tr.CALL_SPAN) if traced \
                else contextlib.nullcontext():
            nin, nout = run.call(i)
        t1 = time.perf_counter()
        calls.append((t0, t1, nin, nout, bool(traced)))
        if traced and i == skip + ntrace - 1:
            sync()
            prof.stop()
        i += 1
        if t1 - start >= args.seconds and (not args.trace
                                           or i >= skip + ntrace):
            break
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) if on_card else 0
    if prof is not None:
        events = tr.from_profiler(prof)
        del prof

    checks, failed = run.judge(log)
    correct = all(v <= lim for v, lim in checks.values())
    name = args.workload
    result = {"correct": correct, "attempted": len(calls), "failed": failed}
    device = {"platform": "gpu" if on_card else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0]) if on_card
              else devices[0].type,
              "count": len(devices), "memory_peak_bytes": int(peak)}
    metrics = {}
    if args.trace:
        t = tr.Traced(events, [d.index or 0 for d in devices] if on_card
                      else [-1],
                      in_bytes=sum(c[2] for c in calls if c[4]),
                      out_bytes=sum(c[3] for c in calls if c[4]),
                      untraced_s=[c[1] - c[0] for c in calls if not c[4]])
        for m in bench["per_layer"]:
            if applies(m, name):
                value = metric_reader(m["name"])(t, run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=t.busy_s(), window_s=t.window_s())
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    else:
        e2e = dict(kind.Cell.end_to_end([c[:4] for c in calls], start),
                   setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result.update(metrics=metrics, device=device)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
