"""One-shot device measurement roundup (K7 and the measurement path).

Counterpart of ``scripts/exp_device_roundup.py``.  ``main(sections)`` runs,
in order, with a warm-up before each timing and a sync ending each pass:

- "1": the launch probe (K7, the script's lines 57-78): ``grid_copy`` of a
  float32 [128, 128] tile by 1, 16 and 64 blocks that split it, ms per
  call and per block on the host clock, by CUDA events and replayed from a
  CUDA graph;
- "2": the dynamic compress tiers (the script's lines 80-118): dyn1 and
  dyn2 over the corpus in batches of 4 chunks (BFINAL clear), best of 4
  passes after a warm-up, in MB/s with the ratio; every chunk must
  inflate through ``zlib``.  The script times each tier's XLA and Pallas
  entries; in the port both are one path, whose bit placement is the pack
  kernel K2;
- "3": the DP tiers "opt" and "optD" (the script's lines 82-110, the
  same lines as section 2) the same way, through
  ``compress_chunks_optimal`` and ``compress_chunks_optimal_deep``: the
  script's XLA and Pallas rows give the same bits at 1 MiB chunks, and in
  the port they are one path through K1 and K2;
- "4": CRC-32 and Adler-32 of 8 corpus chunks (lines 122-136) through
  ``ops/checksums.py``, each equal to ``zlib``, in GB/s on the host clock
  and replayed from a CUDA graph (the card's time alone);
- "5": K3 on zlib-6 streams of the same 8 chunks (lines 138-170) through
  ``decompress_chunks_words``, bit-exact, in MB/s;
- "tok": the tokenize-only ceiling (K4), ``exp_tokenize_ceiling``;
- "overhead": the grid and loop probes (K5, K6), ``exp_launch_overhead``.

The default is every section.
``grid_copy`` launches ``csrc/launch_probes.cu`` for CUDA tensors and
computes its plain version, ``x.clone()``, for CPU tensors; launches are
counted in ``grid_copy.launches``.

Run (on a CUDA machine): ``python -m
libdeflate_tpu_torch.experiments.exp_device_roundup [1 2 4 5 tok overhead]``.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np
import torch

from .. import _build
from ..compress.dynamic import (
    compress_chunks_dynamic,
    compress_chunks_dynamic2,
)
from ..compress.optimal import (
    compress_chunks_optimal,
    compress_chunks_optimal_deep,
)
from ..compress.pipeline import device_stream_to_bytes
from ..decompress.decode import decompress_chunks_words, pack_streams
from ..device import resolve_device
from ..ops import checksums
from . import exp_launch_overhead, exp_tokenize_ceiling, timing
from .corpus import CHUNK, CORPUS_BYTES, make_corpus, zlib_raw

SECTIONS = ("1", "2", "3", "4", "5", "tok", "overhead")
PROBE_STEPS = (1, 16, 64)
TILE = (128, 128)
NCHUNKS = 8
BATCH = 4
# section -> (name, entry): the script's "dyn1 xla"/"dyn1 pal" and "dyn2"
# pairs, then its "opt" and "optD" pairs
TIERS = {"2": (("dyn1", compress_chunks_dynamic),
               ("dyn2", compress_chunks_dynamic2)),
         "3": (("opt", compress_chunks_optimal),
               ("optD", compress_chunks_optimal_deep))}


def reset_launch_counts() -> None:
    grid_copy.launches = 0


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7."""
    return x.clone()


def grid_copy(x: torch.Tensor, steps: int) -> torch.Tensor:
    """x (float32, contiguous, 1 to 1 << 20 elements, any 4-byte offset)
    copied by ``steps`` blocks that split it, each element read and
    written once."""
    if x.dtype != torch.float32 or not 1 <= x.numel() <= 1 << 20:
        raise ValueError(f"x must be float32 with 1 to {1 << 20} elements, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or steps < 1:
        raise ValueError("x must be contiguous and steps >= 1")
    if x.device.type == "cpu":
        return copy_plain(x)
    out = exp_launch_overhead.launch_probe("grid_copy", "grid_copy_launch",
                                           x, x.numel(), steps)
    _build.count_launch(grid_copy)
    return out


def _probe(dev) -> dict:
    x = torch.zeros(TILE, dtype=torch.float32, device=dev)
    res = {}
    for steps in PROBE_STEPS:
        res[steps] = exp_launch_overhead.measure(
            lambda x: grid_copy(x, steps), x, copy_plain, dev, 4)
        print(f"[1] grid={steps}: "
              f"{exp_launch_overhead.format_times(res[steps], steps)}",
              flush=True)
    return res


def _checksums(bufs, dev) -> dict:
    big = torch.as_tensor(bufs, device=dev)
    lens = torch.full((len(bufs),), bufs.shape[1], dtype=torch.int64,
                      device=dev)
    res = {}
    for name, fn, oracle in (("crc32", checksums.crc32_chunks, zlib.crc32),
                             ("adler32", checksums.adler32_chunks,
                              zlib.adler32)):
        dt = timing.best_of(lambda: fn(big, lens, device=dev), dev, 4)
        got = fn(big, lens, device=dev).tolist()
        ok = got == [oracle(b.tobytes()) for b in bufs]
        # the card's time alone: the same calls replayed from a CUDA graph
        card_s = (timing.graph_ms(lambda: fn(big, lens, device=dev), 10)
                  / 1e3 if dev.type == "cuda" else None)
        res[name] = {"gb_s": bufs.size / dt / 1e9, "s": dt, "ok": ok,
                     "graph_s": card_s}
        print(f"[4] {name}: {bufs.size / dt / 1e9:.6f} GB/s ({dt:.6f} s for "
              f"{bufs.size} bytes, host); graph replay "
              + ("not measured" if card_s is None else
                 f"{bufs.size / card_s / 1e9:.6f} GB/s ({card_s:.6f} s)")
              + ("" if ok else " MISMATCH"), flush=True)
    return res


def _compress(bufs, dev, section: str) -> dict:
    batches = [torch.as_tensor(bufs[i:i + BATCH], device=dev)
               for i in range(0, len(bufs), BATCH)]
    res = {}
    for name, fn in TIERS[section]:
        def run():
            return [fn(b, torch.full((len(b),), b.shape[1], device=dev),
                       torch.zeros(len(b), dtype=torch.bool, device=dev),
                       device=dev) for b in batches]

        outs = run()
        dt = timing.best_of(run, dev, 4)
        total_bits = torch.cat([t for _, t in outs]).cpu()
        words = torch.cat([w for w, _ in outs]).cpu()
        ok = all(zlib.decompressobj(-15).decompress(device_stream_to_bytes(
            words[k], total_bits[k])) == bufs[k].tobytes()
            for k in range(len(bufs)))
        ratio = int(((total_bits + 7) // 8).sum()) / bufs.size
        res[name] = {"mb_s": bufs.size / dt / 1e6, "s": dt, "ratio": ratio,
                     "ok": ok}
        print(f"[{section}] {name} (the script's XLA and Pallas entries, "
              f"one path here): {bufs.size / dt / 1e6:.6f} MB/s ({dt:.6f} s "
              f"for {bufs.size} bytes), ratio {ratio:.6f}, every chunk "
              f"through zlib={ok}", flush=True)
    return res


def _decode(bufs, dev) -> dict:
    comp, clen = pack_streams([zlib_raw(b.tobytes()) for b in bufs])
    ca = torch.as_tensor(comp.view(np.int32), device=dev)
    cl = torch.as_tensor(clen, device=dev)
    n, width = bufs.shape
    ol = torch.full((n,), width, dtype=torch.int32, device=dev)
    out, st, _, _ = decompress_chunks_words(ca, cl, ol, width, device=dev)
    ok = bool((st == 0).all()) and np.array_equal(out.cpu().numpy(), bufs)
    dt = timing.best_of(lambda: decompress_chunks_words(
        ca, cl, ol, width, device=dev), dev, 4)
    print(f"[5] K3 decode: {bufs.size / dt / 1e6:.6f} MB/s ({dt:.6f} s for "
          f"{n} x {width} bytes), bit-exact={ok}", flush=True)
    return {"mb_s": bufs.size / dt / 1e6, "s": dt, "ok": ok}


def main(sections=None, device=None, total: int = CORPUS_BYTES,
         chunk: int = CHUNK) -> dict:
    """Run the sections (default: all of them) on ``device`` (CUDA
    unless named) over a corpus of ``total`` bytes in ``chunk``-byte
    chunks; print the script's lines and return {section: results}, each
    result with an "ok" flag."""
    sections = list(SECTIONS if sections is None else sections)
    for s in sections:
        if s not in SECTIONS:
            raise ValueError(f"unknown section {s!r}; the sections are "
                             f"{SECTIONS}")
    dev = resolve_device(device)
    print(f"device: {timing.describe(dev)}", flush=True)
    corpus = make_corpus(total)
    nch = len(corpus) // chunk
    bufs = np.frombuffer(corpus[:nch * chunk], np.uint8).reshape(
        nch, chunk).copy()
    first = bufs[:NCHUNKS]
    res = {}
    if "1" in sections:
        res["1"] = _probe(dev)
    for s in ("2", "3"):
        if s in sections:
            res[s] = _compress(bufs, dev, s)
    if "4" in sections:
        res["4"] = _checksums(first, dev)
    if "5" in sections:
        res["5"] = _decode(first, dev)
    if "tok" in sections:
        res["tok"] = exp_tokenize_ceiling.ceiling_table(
            device=dev, total=total, chunk=chunk, corpus=corpus)
        for line in exp_tokenize_ceiling.format_table(res["tok"]):
            print(f"[tok] {line}", flush=True)
    if "overhead" in sections:
        res["overhead"] = exp_launch_overhead.overhead_table(dev)
        for line in exp_launch_overhead.format_table(res["overhead"]):
            print(f"[overhead] {line}", flush=True)
    return res


def all_ok(res) -> bool:
    """True if every "ok" flag in a result tree is true."""
    if isinstance(res, dict):
        return all(v if k == "ok" else all_ok(v) for k, v in res.items())
    return True


reset_launch_counts()

if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(0 if all_ok(main([a for a in args if a != "--cpu"] or None,
                              "cpu" if "--cpu" in args else None)) else 1)
