"""The device tiers' ratio gap, split into parse loss and entropy-coding
loss.

Counterpart of ``scripts/exp_ratio_gap.py``: first dyn1, dyn2 and dyn3
(``compress_chunks_dynamic{,2,3}``) over the 16 MiB corpus in batches of
4, each batch timed alone (best of 3, ending in
``torch.cuda.synchronize()``), MB/s and ratio a tier.  Then the L6 tier's
parse (``pipeline.parse_chunk``: lazy, depth 6, 128 KiB windows) taken to
the host and its items re-costed three ways: with the device's 11-bit
code lengths (``dynamic.build_code_lens_pair``: the build C2 on the
card), and with optimal package-merge lengths
(``huffman.build.package_merge_lengths``) capped at 11 and at 15 bits;
the header counted as the fixed 1338 bits throughout.  Runs on CUDA
(raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_ratio_gap
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..compress.bits import length_slot, offset_slot
from ..compress.dynamic import (HDR_BITS, NDIST, NSYM, build_code_lens_pair,
                                compress_chunks_dynamic,
                                compress_chunks_dynamic2,
                                compress_chunks_dynamic3)
from ..compress.pipeline import parse_chunk
from ..device import resolve_device
from ..huffman.build import package_merge_lengths
from . import corpus as pc
from .driver_common import batches, device_args
from .timing import best_of, describe

B = 4
CONFIGS = {"dyn1 (L2-6)": compress_chunks_dynamic,
           "dyn2 (L7)": compress_chunks_dynamic2,
           "dyn3 (L8+)": compress_chunks_dynamic3}
L6_PARSE = dict(lazy=True, two_pass=False, depth=6, hash3=False,
                wide_ext=False, wide_window=True)


def item_hists(bp, cm, cl, eff, dist):
    """The items of one chunk's parse (host arrays): (litlen histogram
    [286] with one end-of-block, offset histogram [30], extra bits)."""
    lits = bp[cl]
    mlen = torch.as_tensor(eff[cm])
    mdist = torch.as_tensor(dist[cm])
    lslot, _, lextra = (x.numpy() for x in length_slot(mlen))
    oslot, _, oextra = (x.numpy() for x in offset_slot(mdist))
    hl = np.bincount(lits, minlength=NSYM).astype(np.int64)
    hl[257:] = 0
    hl[257 + np.arange(29)] = np.bincount(lslot, minlength=29)[:29]
    hl[256] = 1
    hd = np.bincount(oslot, minlength=NDIST).astype(np.int64)
    return hl, hd, int(lextra.sum() + oextra.sum())


def recost(rows: np.ndarray, dev: torch.device) -> dict:
    """Bits of the L6 parse's items of every chunk of rows under the
    device's code lengths ("kraft") and package-merge at 11 and 15 bits
    ("pm11", "pm15"), each with the fixed header; per chunk."""
    out = {"kraft": [], "pm11": [], "pm15": []}
    for bufs, lengths, _ in batches(rows, B, dev):
        parsed = parse_chunk(bufs, lengths, **L6_PARSE)
        bp, _, cm, cl, eff, dist = (x.cpu().numpy() for x in parsed)
        for k in range(bufs.shape[0]):
            if len(out["kraft"]) >= rows.shape[0]:
                break
            hl, hd, extra = item_hists(bp[k], cm[k], cl[k], eff[k], dist[k])
            ll, dl, _, _ = build_code_lens_pair(
                torch.as_tensor(hl, device=dev)[None],
                torch.as_tensor(hd, device=dev)[None], 0)
            ll, dl = ll[0].cpu().numpy(), dl[0].cpu().numpy()
            out["kraft"].append(int((hl * ll).sum() + (hd * dl).sum())
                                + extra + HDR_BITS)
            for cap in (11, 15):
                l1 = package_merge_lengths(hl, cap)
                l2 = package_merge_lengths(
                    np.maximum(hd, np.where(np.arange(NDIST) < 2, 1, 0)), cap)
                out[f"pm{cap}"].append(int((hl * l1).sum() + (hd * l2).sum())
                                       + extra + HDR_BITS)
    return out


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = pc.chunk_rows(pc.make_corpus(args.total), args.chunk)
    work = batches(rows, B, dev)
    print(f"{rows.shape[0]} chunks of {args.chunk} bytes, B={B}; "
          f"{describe(dev)}", flush=True)
    for name, fn in CONFIGS.items():
        tot_t, tot_b = 0.0, 0
        for b in work:
            tot_t += best_of(lambda: fn(*b, device=dev), dev, 3)
            _, t = fn(*b, device=dev)
            tot_b += int(((t.cpu() + 7) // 8).sum())
        print(f"{name}: {rows.size / tot_t / 1e6:7.1f} MB/s  "
              f"ratio {tot_b / rows.size * 100:.3f}%", flush=True)
    bits = recost(rows, dev)
    tot = rows.size * 8
    print(f"L6 parse re-cost: device-kraft {sum(bits['kraft']) / tot * 100:.3f}%"
          f"  pm11 {sum(bits['pm11']) / tot * 100:.3f}%  "
          f"pm15 {sum(bits['pm15']) / tot * 100:.3f}%", flush=True)
    print("(header modeled as fixed 1338 bits in all cases; RLE'd headers "
          "~340 bits)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
