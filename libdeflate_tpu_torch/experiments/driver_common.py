"""What the ports of the measurement and ratio drivers of ``scripts/``
share: the profilers' timed lines, batches of chunks, and the ratio
drivers' loop over a set of chunks.

- ``Bench`` is the scripts' ``bench(name, fn, *args)``: it runs fn, times
  it (``timing.stage_ms``: host clock and CUDA events, median of reps),
  prints the line and returns fn's result, so that a profiler's stages
  chain as the script's do.  With ``reps=0`` it only runs fn and keeps
  the result (the CPU tests hold each stage's output to the JAX package);
  ``trace()`` adds each line's device busy time from one profiled run
  of every line (``traced_busy``).
- ``batches`` cuts uint8 [n, N] chunks into batches of B on a device, the
  last padded with zero chunks of length N, as the scripts pad it.
- ``ratio_run`` compresses every chunk of a set through one entry, checks
  the chunks the script checks through zlib, and returns the compressed
  sizes, the per-chunk total_bits and the streams; ``pipelined`` is the
  scripts' timing of a set (every batch issued, then one wait).
"""

from __future__ import annotations

import argparse
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..compress.pipeline import device_stream_to_bytes
from . import corpus as pc
from .timing import describe, ms_text, stage_ms, sync


def device_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    return ap


def text_batch(B: int, chunk: int, root: Path = pc.REPO) -> np.ndarray:
    """uint8 [B, chunk]: the profilers' input, ``native/ldtpu_native.cpp``
    repeated to B * chunk bytes (the scripts repeat the reference's
    ``lib/deflate_compress.c``)."""
    base = (root / pc.TEXT2).read_bytes()
    data = (base * (chunk * B // len(base) + 1))[: chunk * B]
    return np.frombuffer(data, np.uint8).reshape(B, chunk)


def on_device(rows: np.ndarray, dev: torch.device, final: bool = False):
    """(bufs, lengths, bfinal) tensors of uint8 [B, N] rows, each of
    length N."""
    B, N = rows.shape
    return (torch.as_tensor(rows.copy(), device=dev),
            torch.full((B,), N, dtype=torch.int64, device=dev),
            torch.full((B,), final, dtype=torch.bool, device=dev))


def batches(rows: np.ndarray, B: int, dev: torch.device):
    """Batches of B rows on dev, none final; the last padded with zero
    rows of full length, as the scripts pad it."""
    out = []
    for i in range(0, rows.shape[0], B):
        bb = rows[i:i + B]
        if bb.shape[0] < B:
            bb = np.concatenate(
                [bb, np.zeros((B - bb.shape[0], rows.shape[1]), np.uint8)])
        out.append(on_device(bb, dev))
    return out


def traced_busy(calls, dev: torch.device) -> dict:
    """One run of each (name, fn) of ``calls`` in one ``torch.profiler``
    session on CUDA, each inside a ``record_function`` range of its name
    and ending in a sync: name -> {"busy_ms": the union of the device's
    kernels, copies and memsets within the range, "window_ms": the
    range, "device_ops": their count}.  One session for all: the
    profiler stops seeing the card after some sessions in one process."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, fn in calls:
                with record_function(name):
                    fn()
                    sync(dev)
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    out = {}
    for name, _ in calls:
        rng = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == name]
        if not rng:
            continue
        lo = float(rng[0]["ts"])
        hi = lo + float(rng[0]["dur"])
        busy, n, cur = 0.0, 0, None
        for s, e in dev_ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            n += 1
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        out[name] = {"busy_ms": busy / 1e3, "window_ms": (hi - lo) / 1e3,
                     "device_ops": n}
    return out


class Bench:
    """``bench(name, fn, *args)``: runs fn(*args), times it unless reps is
    0, prints and keeps a line, and returns the result (``keep`` False:
    the result is dropped, as the script's lines without ``keep``).
    ``trace()`` afterwards runs every line once more under the profiler
    and prints each line's device busy time (``traced_busy``)."""

    def __init__(self, dev: torch.device, reps: int, per: int, width=46,
                 log=print):
        self.dev, self.reps, self.per, self.width = dev, reps, per, width
        self.log = log
        self.rows: list[dict] = []
        self.outputs: dict = {}
        self.calls = []

    def __call__(self, name: str, fn, *args, keep: bool = True):
        out = fn(*args)
        sync(self.dev)
        self.outputs[name] = out
        self.calls.append((name, lambda: fn(*args)))
        if self.reps:
            host, events = stage_ms(lambda: fn(*args), self.dev, self.reps)
            self.rows.append({"name": name, "host_ms": host,
                              "event_ms": events})
            self.log(f"{name:{self.width}s} host {host:10.3f} ms  events "
                     f"{ms_text(events):>14s}  ({host / self.per:8.3f} "
                     f"ms/chunk)", flush=True)
        return out if keep else None

    def trace(self) -> None:
        """Each line's device busy ms in one traced run of every line
        (CUDA only), printed and added to its row."""
        if self.dev.type != "cuda":
            return
        busy = traced_busy(self.calls, self.dev)
        self.log(f"traced, one call a line (the device's busy time in the "
                 f"line's range; {describe(self.dev)}):", flush=True)
        for row in self.rows:
            b = busy.get(row["name"])
            if b is None:
                continue
            row.update(b)
            self.log(f"{row['name']:{self.width}s} busy {b['busy_ms']:10.3f} "
                     f"ms of {b['window_ms']:10.3f} ms  ({b['device_ops']} "
                     f"device ops)", flush=True)


def header(dev: torch.device, B: int, chunk: int, reps: int, log=print):
    log(f"B={B} chunks of {chunk} bytes; reps={reps} (median); "
        f"{describe(dev)}", flush=True)


def ratio_run(entry, rows: np.ndarray, B: int, dev: torch.device,
              verify_every: int = 4, outs=None) -> dict:
    """Every chunk of ``rows`` through ``entry`` (bufs, lengths, bfinal,
    device -> words, total_bits) in batches of B, none final (or the
    entry's outputs ``outs`` of those batches); chunks k with k %
    verify_every == 0 are inflated through zlib.  Returns {"bytes":
    compressed sizes, "total_bits", "streams", "ok": every checked chunk
    inflated to itself}."""
    sizes, bits, streams = [], [], []
    ok = True
    k = 0
    if outs is None:
        outs = [entry(*args, device=dev) for args in batches(rows, B, dev)]
    for words, total in outs:
        words, total = words.cpu(), total.cpu()
        for j in range(B):
            if k >= rows.shape[0]:
                break
            stream = device_stream_to_bytes(words[j], int(total[j]))
            if k % verify_every == 0 and \
                    zlib.decompressobj(-15).decompress(stream) != \
                    rows[k].tobytes():
                ok = False
            sizes.append(len(stream))
            bits.append(int(total[j]))
            streams.append(stream)
            k += 1
    return {"bytes": sizes, "total_bits": bits, "streams": streams,
            "ok": ok}


def pipelined(entry, work, dev: torch.device, passes: int):
    """The scripts' timing: one warm-up pass, then the best of ``passes``
    passes that issue every batch of ``work`` and then wait once.
    Returns (seconds, the last pass's outputs)."""
    outs = [entry(*b, device=dev) for b in work]
    sync(dev)
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        outs = [entry(*b, device=dev) for b in work]
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, outs
