"""Ratio A/B of lean DP tier variants on the XLA-path entry.

Counterpart of ``scripts/ratio_ab.py``: the same variants under the same
names (``VARIANTS``, lines 28-38), each ``parse_chunk_optimal`` at depth
6, one cost pass, no content pass, 16-byte payloads, LEN_LADDER_DENSE2,
raw candidate C, plus the variant's keywords, then a dynamic block at the
variant's refinement passes: here ``compress_chunks_optimal_with`` with
those keywords (``refine_passes`` the script's ``refine``).  Every chunk
of the 16 MiB corpus (``experiments/corpus.py``; ``--sample`` every
other), one chunk a call as the script calls it, none final; every fourth
chunk inflated through zlib.  It prints each variant's ratio and OK (or
MISMATCH); the speed is not the point.  Runs on CUDA (raising without it)
unless ``--device cpu``; names as arguments run the variants whose names
contain one of them:

    python -m libdeflate_tpu_torch.experiments.ratio_ab [names] [--sample]
"""

from __future__ import annotations

import argparse
import functools
import sys

from ..compress.kernels import LEN_LADDER_DENSE2
from ..compress.optimal import compress_chunks_optimal_with
from ..device import resolve_device
from . import corpus as pc
from .driver_common import device_args, ratio_run
from .timing import describe

CHUNK = pc.CHUNK

# name -> (the variant's keywords, emit refine passes), as the script's
VARIANTS = {
    "base(rawC,dense2,p1)": (dict(), 16),
    "rowlit": (dict(row_lit1=True), 16),
    "lcp12": (dict(lcp=12), 16),
    "rowlit+lcp12": (dict(row_lit1=True, lcp=12), 16),
    "ext2shrink": (dict(strides2=(32, 64, 128)), 16),
    "ext2none": (dict(strides2=()), 16),
    "rowlit+ext2shrink": (dict(row_lit1=True, strides2=(32, 64, 128)), 16),
    "ext2none+cap11": (dict(strides2=()), 0),
    "ext2none+refine4": (dict(strides2=()), 4),
}
BASE = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=LEN_LADDER_DENSE2,
            ext_c=False)


def entry(name: str):
    """The variant's compress entry (bufs, lengths, bfinal, device)."""
    kw, refine = VARIANTS[name]
    return functools.partial(compress_chunks_optimal_with, **BASE, **kw,
                             refine_passes=refine)


CONFIGS = {name: entry(name) for name in VARIANTS}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = pc.chunk_rows(pc.make_corpus(args.total), args.chunk)
    if args.sample:
        rows = rows[::2]
    print(f"{rows.shape[0]} chunks of {args.chunk} bytes, B={args.batch}; "
          f"{describe(dev)}", flush=True)
    ok_all = True
    for name, fn in CONFIGS.items():
        if args.names and not any(n in name for n in args.names):
            continue
        res = ratio_run(fn, rows, args.batch, dev, verify_every=4)
        ok_all &= res["ok"]
        print(f"{name:24s} ratio {sum(res['bytes']) / rows.size:.5f}"
              f"  {'OK' if res['ok'] else 'MISMATCH'}", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
