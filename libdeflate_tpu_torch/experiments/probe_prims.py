"""Primitive cost probe on the card: what the port's candidates and emit
are built from, at a batch's size (4M elements).

Counterpart of ``scripts/probe_prims.py`` (lines 47-111), the same
operations as torch ops on int32 tensors:

- ten elementwise ops;
- gathers (``jnp.take``: ``index_select``) from a 512-entry, a 32K-entry
  and a 4M-entry table;
- scatter-adds (``.at[].add``: ``index_add_``) into 4M and into a
  317-bin histogram;
- sorts of 1-9 operands over 64K-element segments, and of 5 operands over
  128K and 32K segments (``lax.sort`` of k operands: ``torch.sort`` of the
  key, then a ``gather`` of each payload by its indices, as the port's
  ``pipeline._sort3`` does);
- ``cumsum``;
- the 1024-step ``lax.scan`` as a host loop of 1024 torch steps over 4K
  lanes, which is how the port's own loops pay.

Each line gives the median of ``--reps`` calls (5) by the host clock,
ending in ``torch.cuda.synchronize()``, less the null floor's, and by CUDA
events with the card's queue filled before the call
(``timing.stage_ms``): the two differ where the host paces the
operation.  Runs on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.probe_prims [--n 4194304]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from .driver_common import device_args
from .timing import describe, ms_text, stage_ms

REPS = 5
N = 1 << 22


def sort_k(keys, *pays):
    """A k-operand sort along the last axis: the key's values and order,
    then each payload gathered by that order."""
    k, order = torch.sort(keys, dim=-1)
    return (k,) + tuple(p.gather(-1, order) for p in pays)


def scan_steps(xs):
    """``lax.scan(lambda c, r: (c + r, c), 0, xs)[0]`` as a host loop:
    one torch add a step."""
    c = torch.zeros_like(xs[0])
    for r in xs:
        c = c + r
    return c


def probes(n: int, dev: torch.device, rng) -> list:
    """[(name, fn, args)] of the script's operations at n elements."""

    def t(x):
        return torch.as_tensor(x, device=dev)

    u = t(rng.integers(0, 1 << 30, n, np.int32))
    keys = t(rng.integers(0, 1 << 31, n, np.int64).astype(np.int32))
    out = [("elementwise x10 [4M]",
            lambda x: ((((x * 3 + 1) ^ (x >> 2)) * 5 + (x >> 7))
                       ^ (x * 9)) + 1, (u,))]
    for size, label in ((512, "512"), (32768, "32K"), (n, "4M")):
        tbl = t(rng.integers(0, 1000, size, np.int32))
        idx = t(rng.integers(0, size, n, np.int64))
        out.append((f"gather {label}-table [4M]",
                    lambda tb, i: tb.index_select(0, i), (tbl, idx)))
    sidx = t(rng.integers(0, n, n, np.int64))
    out.append(("scatter-add [4M]->[4M]",
                lambda v, i: torch.zeros(n, dtype=v.dtype, device=dev)
                .index_add_(0, i, v), (u, sidx)))
    hidx = t(rng.integers(0, 317, n, np.int64))
    out.append(("scatter-add hist [4M]->[317]",
                lambda v, i: torch.zeros(317, dtype=v.dtype, device=dev)
                .index_add_(0, i, torch.ones_like(v)), (u, hidx)))
    seg = min(65536, n)
    pays = [t(rng.integers(0, 1 << 31, n, np.int64).astype(np.int32))
            for _ in range(8)]
    for nops in (1, 2, 3, 5, 7, 9):
        out.append((f"sort {n // seg}x[64K] {nops} operands", sort_k,
                    tuple(x.reshape(-1, seg) for x in
                          [keys] + pays[: nops - 1])))
    for s, label in ((min(131072, n), "128K"), (min(32768, n), "32K")):
        out.append((f"sort {n // s}x[{label}] 5 operands", sort_k,
                    tuple(x.reshape(-1, s) for x in [keys] + pays[:4])))
    out.append(("torch.cumsum [4M]", lambda x: torch.cumsum(x, 0), (u,)))
    out.append(("host loop 1024 steps x [4K] lanes", scan_steps,
                (u.reshape(1024, -1),)))
    return out


def run(dev: torch.device, n: int = N, reps: int = REPS,
        log=print) -> list[dict]:
    rng = np.random.default_rng(3)
    tiny = torch.ones(128, dtype=torch.int32, device=dev)
    floor, floor_ev = stage_ms(lambda: tiny * 2, dev, reps)
    log(f"{'null floor':52s} host {floor:9.3f} ms  events "
        f"{ms_text(floor_ev)}; {describe(dev)}", flush=True)
    rows = []
    for name, fn, args in probes(n, dev, rng):
        host, events = stage_ms(lambda: fn(*args), dev, reps)
        rows.append({"name": name, "host_ms": host - floor,
                     "event_ms": events})
        log(f"{name:52s} host {host - floor:9.3f} ms  events "
            f"{ms_text(events)}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--n", type=int, default=N,
                    help="elements (a multiple of 131072, or smaller "
                         "segments follow)")
    args = ap.parse_args(argv)
    run(resolve_device(args.device), args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
