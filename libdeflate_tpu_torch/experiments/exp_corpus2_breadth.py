"""Candidate breadth against the text loss, on both corpora, per class.

Counterpart of ``scripts/exp_corpus2_breadth.py``: the same twelve
variants (lines 65-96) of the lean tier, ``_compress_chunks_optimal_pallas``
at depth 6, one cost pass, LEN_LADDER_DENSE2, raw C, no second stride
round, refine 0, every fourth byte in the literal histogram, with the
depth (10, 16, 24), hash3, the rescue pass, a second cost pass, the
content pass, and the optfast and deep settings changed: here
``compress_chunks_optimal_pallas_with`` with those keywords.  On the
second corpus (``corpus.make_corpus2``), then the first
(``make_corpus``): each variant over the whole corpus in batches of 4
(the last padded with zero chunks), none final, timed as the script times
it (a warm-up pass, then the best of 3 passes that issue every batch and
wait once, ending in ``torch.cuda.synchronize()``), every fourth chunk
inflated through zlib; then each class span (``corpus2_classes``,
``corpus1_classes``) compressed alone, its ratio beside the reference's.

The script's reference is libdeflate -6, built from the reference's
source tree (lines 47-62), which this repository does not hold: a line
says so, and the class ratios of zlib level 6 (raw DEFLATE of each class
span in 1 MiB chunks) stand beside the variants, labelled ``zlib-6``.
Runs on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_corpus2_breadth [names]
"""

from __future__ import annotations

import argparse
import functools
import sys

from ..compress.kernels import LEN_LADDER, LEN_LADDER_DENSE2
from ..compress.optimal import compress_chunks_optimal_pallas_with
from ..device import resolve_device
from . import corpus as pc
from .driver_common import batches, device_args, pipelined, ratio_run
from .timing import describe

B = 4
LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=LEN_LADDER_DENSE2,
            ext_c=False, strides2=(), refine=0, lit_sample=4)
# name -> the keywords the script changes from LEAN
VARIANTS = {
    "lean(d6)": {},
    "lean-d10": dict(depth=10),
    "lean-d16": dict(depth=16),
    "lean-d24": dict(depth=24),
    "lean-d16-h3": dict(depth=16, hash3=True),
    "lean-d16-2p": dict(depth=16, two_pass=True),
    "lean-d16-p2": dict(depth=16, passes=2),
    "lean-content": dict(use_content=True),
    "lean-d12-content": dict(depth=12, use_content=True),
    "optfast(p2)": dict(passes=2, refine=16, lit_sample=1),
    "optf-d16": dict(passes=2, refine=16, lit_sample=1, depth=16),
    "deep": dict(depth=12, two_pass=True, hash3=True, passes=3,
                 use_content=True, use_wide=True, ladder=LEN_LADDER,
                 ext_c=True, strides2=(1, 2, 4, 8, 16, 32, 64, 128),
                 refine=16, lit_sample=1, content_doublings=2),
}


def options(name: str) -> dict:
    return {**LEAN, **VARIANTS[name]}


CONFIGS = {name: functools.partial(compress_chunks_optimal_pallas_with,
                                   **options(name)) for name in VARIANTS}


def zlib6_class_ratios(corpus: bytes, classes, chunk: int) -> dict:
    """zlib level 6's ratio of each class span, in ``chunk``-byte chunks
    of raw DEFLATE."""
    out = {}
    for name, lo, hi in classes:
        data = corpus[lo:hi]
        comp = sum(len(pc.zlib_raw(data[i:i + chunk]))
                   for i in range(0, len(data), chunk))
        out[name] = comp / max(len(data), 1)
    return out


def run_variant(fn, rows, dev, passes: int = 3, verify_every: int = 4):
    """(seconds of the best pass, ``ratio_run``'s result) of one variant
    over rows."""
    work = batches(rows, B, dev)
    dt, outs = pipelined(fn, work, dev, passes)
    return dt, ratio_run(fn, rows, B, dev, verify_every, outs=outs)


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--c2only", action="store_true")
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    todo = {k: f for k, f in CONFIGS.items()
            if not args.names or any(n in k for n in args.names)}
    print(describe(dev), flush=True)
    print("no libdeflate -6 reference ratios (its source tree is not in "
          "this repository); zlib level 6's stand beside the variants, "
          "labelled zlib-6", flush=True)
    ok_all = True
    for tag, make, classes in (
            ("corpus2", pc.make_corpus2, pc.corpus2_classes),
            ("corpus1", pc.make_corpus, pc.corpus1_classes)):
        corpus = make(args.total)
        cls = classes(args.total)
        rows = pc.chunk_rows(corpus, args.chunk)
        cls_rows = {name: pc.chunk_rows(corpus[lo:hi], args.chunk)
                    for name, lo, hi in cls}
        ref = zlib6_class_ratios(corpus, cls, args.chunk)
        ref_all = zlib6_class_ratios(corpus, [("all", 0, rows.size)],
                                     args.chunk)["all"]
        print(f"\n== {tag} ==  zlib-6: "
              + "  ".join(f"{k}={v * 100:.2f}" for k, v in ref.items())
              + f"  all={ref_all * 100:.2f}", flush=True)
        for name, fn in todo.items():
            dt, res = run_variant(fn, rows, dev, args.passes)
            ok_all &= res["ok"]
            per = []
            for cname, crows in cls_rows.items():
                r = sum(ratio_run(fn, crows, B, dev,
                                  verify_every=1 << 30)["bytes"]) / crows.size
                per.append(f"{cname}={r * 100:.2f}"
                           f"({(r - ref[cname]) * 100:+.2f} zlib-6)")
            print(f"{name:18s} {rows.size / dt / 1e6:7.1f} MB/s  "
                  f"all={sum(res['bytes']) / rows.size * 100:.3f}%  "
                  + "  ".join(per)
                  + ("" if res["ok"] else "  MISMATCH"), flush=True)
        if args.c2only:
            break
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
