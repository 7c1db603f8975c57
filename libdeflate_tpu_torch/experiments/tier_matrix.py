"""Speed and ratio matrix of the DP tier configurations.

Counterpart of ``scripts/tier_matrix.py``: the same configurations under
the same names (``tier_configs``, lines 31-99), each
``compress_chunks_optimal_pallas_with`` with the keywords the script
gives ``_compress_chunks_optimal_pallas``, and "leanfinal" as
``compress_chunks_lean``; the same loop (``run_config``, ``main``): the
16 MiB corpus (``experiments/corpus.py``) in 1 MiB chunks, batches of
``--batch`` chunks (4), none final, one warm-up pass, then the best of 4
timed passes on the host clock, each ending in
``torch.cuda.synchronize()``; the ratio over every chunk and a zlib round
trip of chunks k < 4 and every fifth.  It prints GB/s, the ratio and OK
(or ROUND-TRIP MISMATCH, or FAILED and the error) a configuration, and
exits non-zero if any configuration failed or mismatched.

Runs on CUDA (raising without it) unless ``--device cpu``; names as
arguments run the configurations whose names contain one of them:

    python -m libdeflate_tpu_torch.experiments.tier_matrix [names] [--batch B]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
import zlib

import numpy as np
import torch

from ..compress.kernels import LEN_LADDER_DENSE, LEN_LADDER_DENSE2
from ..compress.optimal import (
    compress_chunks_lean,
    compress_chunks_optimal_pallas_with,
)
from ..compress.pipeline import device_stream_to_bytes
from ..device import resolve_device
from . import corpus as pc

CHUNK = pc.CHUNK
BATCH = 4

_BASE = dict(depth=6, two_pass=False, hash3=False, passes=2)
_LEAN = dict(use_content=False, use_wide=False, ladder=LEN_LADDER_DENSE)
_P1 = dict(depth=6, two_pass=False, hash3=False, passes=1)
_P1D2 = dict(_P1, use_content=False, use_wide=False,
             ladder=LEN_LADDER_DENSE2)
# name -> compress_chunks_optimal_pallas_with keywords (None: the lean
# entry), as scripts/tier_matrix.py names and sets them
CONFIGS = {
    "opt2-pallas(base)": dict(_BASE),
    "leanB(no-content)": dict(_BASE, use_content=False),
    "leanC(B+no-wide)": dict(_BASE, use_content=False, use_wide=False),
    "leanD(C+dense)": dict(_BASE, **_LEAN),
    "leanE(D+hash3)": dict(_BASE, hash3=True, **_LEAN),
    "leanF(B+dense)": dict(_BASE, use_content=False,
                           ladder=LEN_LADDER_DENSE),
    "leanG(D+depth4)": dict(_BASE, depth=4, **_LEAN),
    "leanH(D+refine0)": dict(_BASE, **_LEAN, refine=0),
    "leanI(D+flatlit1)": dict(_BASE, **_LEAN, flat_lit1=True),
    "leanJ(D+dense2)": dict(_BASE, use_content=False, use_wide=False,
                            ladder=LEN_LADDER_DENSE2),
    "leanK(G+refine4+flat)": dict(_BASE, depth=4, **_LEAN, refine=4,
                                  flat_lit1=True),
    "lean1(D,passes=1)": dict(_P1, **_LEAN),
    "lean1J(dense2,passes=1)": dict(_P1D2),
    "lean1r0(D,p1,refine0)": dict(_P1, **_LEAN, refine=0),
    "lean1d4(p1,depth4)": dict(_P1, depth=4, **_LEAN),
    "lean1X(p1,rawC)": dict(_P1D2, ext_c=False),
    "lean1F(p1,flat)": dict(_P1D2, flat_lit1=True),
    "lean1XF(p1,rawC,flat)": dict(_P1D2, ext_c=False, flat_lit1=True),
    "lean1XR(p1,rawC,rowlit)": dict(_P1D2, ext_c=False, row_lit1=True),
    "lean1X8(p1,rawC,lcp8)": dict(_P1D2, ext_c=False, lcp8=True),
    "lean1XR8(rawC,rowlit,lcp8)": dict(_P1D2, ext_c=False, row_lit1=True,
                                       lcp8=True),
    "leanfinal": None,
}


def tier_configs(only=()) -> dict:
    """name -> entry (uint8[B, N], lengths, bfinal -> (words,
    total_bits)) of every configuration, or of those whose name contains
    one of ``only``."""
    cfgs = {name: compress_chunks_lean if kw is None
            else functools.partial(compress_chunks_optimal_pallas_with, **kw)
            for name, kw in CONFIGS.items()}
    if only:
        cfgs = {k: v for k, v in cfgs.items() if any(o in k for o in only)}
    return cfgs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_config(name, fn, bufs_np, batches, dev) -> bool:
    """Time one configuration on ``batches`` (the chunks of ``bufs_np``
    in order) and check it; prints its line and returns whether every
    checked chunk round-tripped."""
    try:
        outs = [fn(*b, device=dev) for b in batches]
        _sync(dev)
    except Exception as e:  # the script's report: one line, then go on
        print(f"{name:24s} FAILED: {type(e).__name__}: {str(e)[:120]}",
              flush=True)
        return False
    dt = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        outs = [fn(*b, device=dev) for b in batches]
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
    comp = 0
    k = 0
    ok = True
    for ww, tt in outs:
        ww, tt = ww.cpu(), tt.cpu()
        for j in range(ww.shape[0]):
            stream = device_stream_to_bytes(ww[j], int(tt[j]))
            comp += len(stream)
            if (k < 4 or k % 5 == 0) and \
                    zlib.decompressobj(-15).decompress(stream) != \
                    bufs_np[k].tobytes():
                ok = False
            k += 1
    nbytes = k * bufs_np.shape[1]
    print(f"{name:24s} {nbytes / dt / 1e9:8.4f} GB/s  ratio "
          f"{comp / nbytes:.4f}  {'OK' if ok else 'ROUND-TRIP MISMATCH'}",
          flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    nchunks = len(corpus) // CHUNK
    bufs_np = np.frombuffer(corpus[: nchunks * CHUNK], np.uint8).reshape(
        nchunks, CHUNK)
    B = args.batch
    batches = [(torch.as_tensor(bufs_np[i:i + B].copy(), device=dev),
                torch.full((B,), CHUNK, dtype=torch.int64, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
               for i in range(0, nchunks - B + 1, B)]
    print(f"batch={B}, {len(batches)} batches x {B} chunks", flush=True)
    ok = [run_config(name, fn, bufs_np, batches, dev)
          for name, fn in tier_configs(args.names).items()]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
