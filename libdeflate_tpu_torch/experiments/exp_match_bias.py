"""Sweep of the pass-1 match-bias seed on both corpora.

Counterpart of ``scripts/exp_match_bias.py``: the lean tier
(``_compress_chunks_optimal_pallas`` at depth 6, LEN_LADDER_DENSE2, raw
C, no second stride round, refine 0, every fourth byte in the literal
histogram; ``--p2`` two cost passes) with ``match_bias16`` a [259]
vector, 16 times the shape's bits rounded, subtracted from pass 1's seed
match costs: here ``compress_chunks_optimal_pallas_with`` with those
keywords (``optimal.seed_lc_len`` takes the vector).  The nine shapes of
lines 55-68 (four with ``--p2``) over three sets: the first corpus, the
second corpus's text and its records (``corpus.match_bias_sets``), in
batches of 4 (the last padded with zero chunks), none final; every 16th
chunk inflated through zlib.  A line a shape: each set's compressed
size over its bytes.  Runs on CUDA (raising without it) unless
``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_match_bias [--p2]
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np

from ..compress.kernels import LEN_LADDER_DENSE2
from ..compress.optimal import compress_chunks_optimal_pallas_with
from ..device import resolve_device
from . import corpus as pc
from .driver_common import device_args, ratio_run
from .timing import describe

B = 4
_F = np.arange(259)
SHAPES = {
    "flat0": 0.0 * _F,
    "sh2": np.where(_F <= 8, 2.0, 0.0),
    "sh3": np.where(_F <= 8, 3.0, 0.0),
    "sh4": np.where(_F <= 8, 4.0, 0.0),
    "sh6": np.where(_F <= 8, 6.0, 0.0),
    "sh3+f1": np.where(_F <= 8, 3.0, 0.0) + 1.0,
    "sh4+f2": np.where(_F <= 8, 4.0, 0.0) + 2.0,
    "mid3": np.where(_F <= 16, 3.0, 0.0),
    "taper": np.clip((16 - _F) * 0.5, 0, 5.0),
}
P2_SHAPES = ("flat0", "sh3", "sh4+f2", "taper")
LEAN = dict(depth=6, two_pass=False, hash3=False, use_content=False,
            use_wide=False, ladder=LEN_LADDER_DENSE2, ext_c=False,
            strides2=(), refine=0, lit_sample=4)


def bias16(name: str) -> np.ndarray:
    """The shape's int32 [259] match_bias16."""
    return np.round(SHAPES[name] * 16).astype(np.int32)


def entry(name: str, passes: int = 1):
    return functools.partial(compress_chunks_optimal_pallas_with, **LEAN,
                             passes=passes, match_bias16=bias16(name))


CONFIGS = {name: entry(name) for name in SHAPES}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--p2", action="store_true")
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    passes = 2 if args.p2 else 1
    sets = {tag: pc.chunk_rows(data, args.chunk) for tag, data in
            pc.match_bias_sets(pc.make_corpus(args.total),
                               pc.make_corpus2(args.total)).items()}
    print(f"passes={passes}; sets "
          f"{ {k: v.shape[0] for k, v in sets.items()} } chunks of "
          f"{args.chunk} bytes; {describe(dev)}", flush=True)
    ok_all = True
    for sname in (P2_SHAPES if args.p2 else SHAPES):
        fn = entry(sname, passes)
        line = [f"bias={sname:7s}"]
        for tag, rows in sets.items():
            res = ratio_run(fn, rows, B, dev, verify_every=16)
            ok_all &= res["ok"]
            comp = sum((t + 7) // 8 for t in res["total_bits"])
            line.append(f"{tag}={comp / rows.size * 100:.3f}%")
        print("  ".join(line) + ("" if ok_all else "  MISMATCH"), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
