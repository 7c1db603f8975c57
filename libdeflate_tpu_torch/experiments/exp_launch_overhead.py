"""Launch and per-block overhead probes (K5, K6).

Counterpart of ``scripts/exp_pallas_overhead.py``, which measured the TPU's
per-grid-step overhead:

- ``grid_add_one`` (K5) is ``make_grid_fn`` (lines 31-41): x + 1 over int32
  [n_steps * rows, 128], one CUDA block per (rows, 128) tile;
- ``loop_add_one`` (K6) is ``main``'s ``g`` (54-66): the same x + 1 as one
  grid step that loops over the (8, 128) tiles.  One grid step is the
  whole TPU core, so here it is one persistent wave of a block per SM,
  each block looping over every SM-count-th tile;
- ``main`` times both as the script does (best of 5 on the host clock
  after a warm-up, each pass ending in a sync) at 1, 8, 64 and 256 steps
  and 256 tiles, and ``overhead_table`` adds CUDA-event times of
  back-to-back calls and the card's own time from a CUDA-graph replay
  (a call's host time through ctypes exceeds its kernel's).

For CUDA tensors each wrapper launches its kernel in
``csrc/launch_probes.cu``; for CPU tensors it computes the plain version,
``x + 1``.  Launches are counted in each wrapper's ``launches``.  The
script's last measurement, the dynamic tier at B = 4 (lines 72-82), is
``dynamic_baseline``: ``compress_chunks_dynamic`` (dyn1) on 4 x 1 MiB of
random bytes below 64, best of 5 after a warm-up, which ``main`` prints
after the probes.

Run (on a CUDA machine): ``python -m
libdeflate_tpu_torch.experiments.exp_launch_overhead``.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import _build
from ..compress.dynamic import compress_chunks_dynamic
from ..device import resolve_device
from . import timing

STEP_COUNTS = (1, 8, 64, 256)
ROWS = 8
LANES = 128
LOOP_TILES = 256
HOST_REPS = 5          # the script's best of 5
CUDA_REPS = 100        # calls per CUDA-event or graph-replay timing


def reset_launch_counts() -> None:
    grid_add_one.launches = 0
    loop_add_one.launches = 0


def _check(x: torch.Tensor, rows: int) -> int:
    if not 1 <= rows <= 8 or x.dtype != torch.int32 or x.dim() != 2 \
            or x.shape[1] != LANES or x.shape[0] % rows:
        raise ValueError(f"x must be int32 [n * rows, {LANES}] with 1 <= rows "
                         f"<= 8, got {x.dtype} {tuple(x.shape)}, rows {rows}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return x.shape[0] // rows


def launch_probe(name: str, fn_name: str, x: torch.Tensor,
                 *ints) -> torch.Tensor:
    """Launch ``fn_name`` of ``csrc/launch_probes.cu`` on x (its C
    signature: input and output pointers, ``ints``, the stream) into a new
    output like x; raise if the launch fails."""
    out = torch.empty_like(x)
    fn = _build.kernel("launch_probes", fn_name,
                       [_build.PTR] * 2 + [_build.INT] * len(ints)
                       + [_build.PTR])
    with _build.launch_context((x, out), name) as stream:
        err = fn(ctypes.c_void_p(x.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err}")
    return out


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 and K6."""
    return x + 1


def grid_add_one(x: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """x + 1, one block per (rows, 128) tile of x (int32 [n * rows, 128],
    16-byte aligned on CUDA)."""
    n_steps = _check(x, rows)
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("grid_add_one: x must be 16-byte aligned")
    out = launch_probe("grid_add_one", "grid_add_one_launch", x, n_steps,
                       rows)
    _build.count_launch(grid_add_one)
    return out


def loop_add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 by one persistent wave (a block per SM) whose blocks loop
    over the (8, 128) tiles of x, 16 bytes a thread."""
    ntiles = _check(x, ROWS)
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("loop_add_one: x must be 16-byte aligned")
    out = launch_probe("loop_add_one", "loop_add_one_launch", x, ntiles)
    _build.count_launch(loop_add_one)
    return out


def measure(fn, x, plain, dev, host_reps: int) -> dict:
    """{"host_ms": best of ``host_reps`` host-clock passes of fn(x) (the
    scripts' timing), "cuda_ms": mean of CUDA_REPS back-to-back calls by
    CUDA events, "graph_ms": mean of CUDA_REPS calls replayed from a CUDA
    graph (the card's time alone), both None off CUDA, "ok": fn(x) equals
    plain(x)}."""
    ok = torch.equal(fn(x), plain(x))
    host = 1e3 * timing.best_of(lambda: fn(x), dev, host_reps)
    on_card = dev.type == "cuda"
    return {"host_ms": host, "ok": ok,
            "cuda_ms": timing.cuda_ms(lambda: fn(x), CUDA_REPS)
            if on_card else None,
            "graph_ms": timing.graph_ms(lambda: fn(x), CUDA_REPS)
            if on_card else None}


def overhead_table(device=None) -> dict:
    """{"grid": {n_steps: times}, "loop": times}, each times as
    ``measure`` gives them, at the script's step and tile counts."""
    dev = resolve_device(device)

    def timed(fn, x):
        return measure(fn, x, add_one_plain, dev, HOST_REPS)

    grid = {n: timed(grid_add_one,
                     torch.zeros(n * ROWS, LANES, dtype=torch.int32,
                                 device=dev))
            for n in STEP_COUNTS}
    loop = timed(loop_add_one, torch.zeros(LOOP_TILES * ROWS, LANES,
                                           dtype=torch.int32, device=dev))
    return {"grid": grid, "loop": loop}


def format_times(r: dict, steps: int) -> str:
    """One probe's times, total and per grid step."""
    def one(label, ms):
        return (f"{label} not measured" if ms is None else
                f"{label} {ms:.6f} ms ({ms / steps:.6f} ms/step)")

    return "; ".join([one("host", r["host_ms"]),
                      one("CUDA events", r["cuda_ms"]),
                      one("graph replay", r["graph_ms"])]) + (
        "" if r["ok"] else " MISMATCH")


def format_table(table: dict) -> list[str]:
    lines = [f"grid={n:4d}: {format_times(r, n)}"
             for n, r in table["grid"].items()]
    lines.append(f"1-step loop({LOOP_TILES}): "
                 f"{format_times(table['loop'], 1)}")
    return lines


def dynamic_baseline(device=None, batch: int = 4, n: int = 1 << 20) -> dict:
    """The script's dynamic-tier baseline: dyn1 on ``batch`` chunks of
    ``n`` random bytes below 64 (numpy seed 0), BFINAL clear, best of
    HOST_REPS passes on the host clock after a warm-up.  Returns {"ms",
    "mb_s", "total_bits"}."""
    dev = resolve_device(device)
    data = np.random.default_rng(0).integers(0, 64, (batch, n), np.uint8)
    bufs = torch.as_tensor(data, device=dev)
    lens = torch.full((batch,), n, device=dev)
    bfinal = torch.zeros(batch, dtype=torch.bool, device=dev)
    total_bits = compress_chunks_dynamic(bufs, lens, bfinal, device=dev)[1]
    dt = timing.best_of(lambda: compress_chunks_dynamic(
        bufs, lens, bfinal, device=dev), dev, HOST_REPS)
    return {"ms": 1e3 * dt, "mb_s": batch * n / dt / 1e6,
            "total_bits": total_bits.tolist()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device("cpu" if "--cpu" in argv else None)
    print(f"device: {timing.describe(dev)}", flush=True)
    table = overhead_table(dev)
    for line in format_table(table):
        print(line, flush=True)
    base = dynamic_baseline(dev)
    print(f"compress_chunks_dynamic B=4: {base['ms']:.6f} ms = "
          f"{base['mb_s']:.6f} MB/s", flush=True)
    return 0 if all(r["ok"] for r in [*table["grid"].values(),
                                      table["loop"]]) else 1


reset_launch_counts()

if __name__ == "__main__":
    sys.exit(main())
