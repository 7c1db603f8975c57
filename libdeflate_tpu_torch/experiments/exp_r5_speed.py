"""Speed and ratio of lean and dynamic tier variants on the card.

Counterpart of ``scripts/exp_r5_speed.py``: the same variants (lines
92-103): the lean tier (``_compress_chunks_optimal_pallas`` at depth 6,
one cost pass, LEN_LADDER_DENSE2, raw C, no second stride round, refine
0, every fourth byte in the literal histogram; here
``compress_chunks_optimal_pallas_with``) with the first stride round
trimmed to (1, 2, 8, 32, 128) or (1, 4, 16, 128) and at batches of 8 and
2, and the dynamic tier (``_compress_chunks_dynamic_pallas``; here
``compress_chunks_dynamic_with``) with 8-byte payloads (lcp 8) at depths
4 and 8 and a batch of 8.  Timed as the script times it: every batch of
the 16 MiB corpus issued, then one ``torch.cuda.synchronize()``, best of
4 after a warm-up pass; the ratio over every chunk, every eighth chunk
inflated through zlib.  Runs on CUDA (raising without it) unless
``--device cpu``; names as arguments run the variants whose names
contain one of them:

    python -m libdeflate_tpu_torch.experiments.exp_r5_speed [names]
"""

from __future__ import annotations

import argparse
import functools
import sys

from ..compress.dynamic import compress_chunks_dynamic_with
from ..compress.kernels import LEN_LADDER_DENSE2
from ..compress.optimal import compress_chunks_optimal_pallas_with
from ..device import resolve_device
from . import corpus as pc
from .driver_common import batches, device_args, pipelined, ratio_run
from .timing import describe

LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=LEN_LADDER_DENSE2,
            ext_c=False, strides2=(), refine=0, lit_sample=4)


def _lean(B=4, **kw):
    return functools.partial(compress_chunks_optimal_pallas_with,
                             **{**LEAN, **kw}), B


def _dyn(B=4, **kw):
    return functools.partial(compress_chunks_dynamic_with,
                             **{**dict(two_pass=False, depth=6,
                                       hash3=False), **kw}), B


# name -> (entry, batch), as the script's
VARIANTS = {
    "lean-base": _lean(),
    "lean-s5": _lean(strides1=(1, 2, 8, 32, 128)),
    "lean-s4": _lean(strides1=(1, 4, 16, 128)),
    "lean-B8": _lean(B=8),
    "lean-B2": _lean(B=2),
    "dyn-base": _dyn(),
    "dyn-lcp8": _dyn(lcp=8),
    "dyn-lcp8-d4": _dyn(lcp=8, depth=4),
    "dyn-lcp8-d8": _dyn(lcp=8, depth=8),
    "dyn-lcp8-B8": _dyn(lcp=8, B=8),
}
# the variants whose bits differ (the batch changes no chunk's bits)
CONFIGS = {name: fn for name, (fn, B) in VARIANTS.items()
           if name[-2:] not in ("B8", "B2")}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = pc.chunk_rows(pc.make_corpus(args.total), args.chunk)
    print(f"{rows.shape[0]} chunks of {args.chunk} bytes; {describe(dev)}",
          flush=True)
    ok_all = True
    for name, (fn, B) in VARIANTS.items():
        if args.names and not any(n in name for n in args.names):
            continue
        dt, outs = pipelined(fn, batches(rows, B, dev), dev, args.passes)
        res = ratio_run(fn, rows, B, dev, verify_every=8, outs=outs)
        ok_all &= res["ok"]
        comp = sum((t + 7) // 8 for t in res["total_bits"])
        print(f"{name:14s} B={B}  {rows.size / dt / 1e9:.4f} GB/s  "
              f"ratio {comp / rows.size * 100:.4f}%"
              + ("" if res["ok"] else "  MISMATCH"), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
