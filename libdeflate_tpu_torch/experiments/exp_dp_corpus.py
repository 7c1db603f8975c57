"""Ratio and speed of the dynamic and DP tiers on the corpus.

Counterpart of ``scripts/exp_dp_corpus.py``: dyn1
(``compress_chunks_dynamic``), the DP tier (``compress_chunks_optimal``)
and the deep DP tier (``compress_chunks_optimal_deep``) over the 16 MiB
corpus in batches of 4, none final, timed as the script times it (every
batch issued, then one ``torch.cuda.synchronize()``, best of 4 after a
warm-up pass); MB/s and the ratio over every chunk.  Where the script
checks nothing, every fourth chunk is inflated through zlib here.  Runs
on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_dp_corpus
"""

from __future__ import annotations

import argparse
import sys

from ..compress.dynamic import compress_chunks_dynamic
from ..compress.optimal import (compress_chunks_optimal,
                                compress_chunks_optimal_deep)
from ..device import resolve_device
from . import corpus as pc
from .driver_common import batches, device_args, pipelined, ratio_run
from .timing import describe

B = 4
CONFIGS = {"dyn1": compress_chunks_dynamic,
           "dp": compress_chunks_optimal,
           "dpD": compress_chunks_optimal_deep}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = pc.chunk_rows(pc.make_corpus(args.total), args.chunk)
    print(f"{rows.shape[0]} chunks of {args.chunk} bytes, B={B}; "
          f"{describe(dev)}", flush=True)
    ok_all = True
    for name, fn in CONFIGS.items():
        dt, outs = pipelined(fn, batches(rows, B, dev), dev, args.passes)
        res = ratio_run(fn, rows, B, dev, verify_every=4, outs=outs)
        ok_all &= res["ok"]
        comp = sum((t + 7) // 8 for t in res["total_bits"])
        print(f"{name:4s}: {rows.size / dt / 1e6:7.1f} MB/s  ratio "
              f"{comp / rows.size * 100:.3f}%"
              + ("" if res["ok"] else "  MISMATCH"), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
