"""Ablations of the lean DP tier (leanI) on the card: the whole pipeline
with one stage stubbed a run, each stage's marginal cost inside it.

Counterpart of ``scripts/ablate_lean.py``: ``lean_pipeline`` is the
script's (lines 35-147) over the port's stage functions: candidates at
depth 6 with no content pass and 16-byte payloads, the flat mean literal
cost of pass 1 (``optimal.mean_literal_costs``, the ``flat_lit1``
formula with XLA's logarithm), the DP (K1) over LEN_LADDER_DENSE, the
commit (C1), a second cost pass from the items' code lengths (C2),
``emit_dynamic_pre`` at refine 16, the premerge at cap 61 and the pack
(K2).  The eight ablations (``ABLATIONS``, line 150) stub one stage each:

- ``cand``: no matches (every candidate array zero);
- ``litsort``: a flat 8-bit literal cost in pass 1;
- ``dp``: every position a literal, in both passes;
- ``pass2``: no second cost pass;
- ``littrans2``: a flat 8-bit literal cost in pass 2;
- ``refine``: 11-bit codes, no refinement (the premerge stays at cap 61);
- ``pack``: the premerged rows taken as the words (a wrong stream; the
  pack's cost only).

``main`` runs the 16 MiB corpus (``experiments/corpus.py``) in batches of
4 chunks, none final: one warm-up pass, then the best of 4 timed passes
on the host clock, each ending in ``torch.cuda.synchronize()``; GB/s,
ms a batch and the ablation's marginal cost (the whole pipeline's ms a
batch less the ablation's), and for ``none`` a zlib round trip of chunk
0.  Runs on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.ablate_lean [names]
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib

import torch

from ..compress import kernels
from ..compress.bits import segment_sizes, to_i32
from ..compress.dynamic import (DYN_CAPW_DEEP, dyn_nwords, emit_dynamic_post,
                                emit_dynamic_pre)
from ..compress.optimal import (BIT, DP_SEG, SEED_LC_LEN,
                                code_lens_from_items, commit, dist_cost,
                                dist_cost_from, lc_len_from_lens,
                                literal_costs_with, mean_literal_costs)
from ..compress.pipeline import (device_stream_to_bytes, group_premerge,
                                 parse_candidates)
from ..device import resolve_device
from . import corpus as pc
from .driver_common import batches, device_args
from .timing import describe, sync

CHUNK = 1 << 20
BATCH = 4
DEPTH = 6
LADDER = kernels.LEN_LADDER_DENSE
ABLATIONS = ["none", "cand", "litsort", "dp", "pass2", "littrans2",
             "refine", "pack"]


def lean_pipeline(bufs, lengths, bfinal, ablate=()):
    """leanI: depth 6, no content, no wide payloads, the dense ladder, a
    flat pass-1 literal cost, 2 passes, refine 16, with the stages named
    in ``ablate`` stubbed.  Returns (words int32 [B, W], total_bits)."""
    B, n = bufs.shape
    dev = bufs.device
    if "cand" in ablate:
        n_pad = segment_sizes(n, True)[0]
        bp = torch.nn.functional.pad(bufs, (0, n_pad - n))
        pos = torch.arange(n_pad, device=dev)[None, :]
        z = torch.zeros(B, n_pad, dtype=torch.int64, device=dev)
        lenA, dA, lenB, dB, lenC, dC, d3 = (z,) * 7
    else:
        bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = parse_candidates(
            bufs, lengths, depth=DEPTH, two_pass=False, hash3=False,
            wide_window=True, use_content=False, use_wide=False)
    n_pad = bp.shape[1]
    S = DP_SEG

    cost_lit_full, lit_cache = literal_costs_with(bp, lengths)
    if "litsort" in ablate:
        cost_lit = torch.full_like(cost_lit_full, 8 * BIT)
    else:
        cost_lit = mean_literal_costs(lit_cache, n_pad, per_row=False)
    dists = (dA, dB, dC, d3)
    cds = [dist_cost(d) for d in dists]
    lc_len = torch.as_tensor(SEED_LC_LEN, device=dev)

    def dp(cost_lit, cds, lc_len):
        if "dp" in ablate:
            return (torch.ones_like(lenA), torch.zeros_like(lenA))
        return kernels.dp_parse(cost_lit, lenA, dA, cds[0], lenB, dB, cds[1],
                                lenC, dC, cds[2], d3, cds[3], lc_len, S,
                                LADDER)

    span, dist = dp(cost_lit, cds, lc_len)
    cm, cl, eff = commit(span, dist, pos, lengths, S)
    if "pass2" not in ablate:
        lit_lens, dist_lens = code_lens_from_items(bp, cm, cl, eff, dist)
        if "littrans2" in ablate:
            cost_lit = torch.full_like(cost_lit, 8 * BIT)
        else:
            cost_lit, _ = literal_costs_with(bp, lengths,
                                             table=lit_lens[:, :256] * BIT)
        lc_len = lc_len_from_lens(lit_lens)
        dtab = torch.where(dist_lens > 0, dist_lens, 14) * BIT
        span, dist = dp(cost_lit, [dist_cost_from(dtab, d) for d in dists],
                        lc_len)
        cm, cl, eff = commit(span, dist, pos, lengths, S)

    (val, nb, offs), aux = emit_dynamic_pre(
        bp, cm, cl, eff, dist, 0 if "refine" in ablate else 16)
    sbuf, gw = group_premerge(val, nb, offs, DYN_CAPW_DEEP)
    nwords = dyn_nwords(n)
    if "pack" in ablate:
        words = sbuf[:, : nwords // 128 + 1, :128].reshape(B, -1)[:, :nwords]
    else:
        words = kernels.pack_groups(sbuf, gw, nwords)
    words, total_bits = emit_dynamic_post(words, aux, bfinal)
    return to_i32(words), total_bits


def ablation(name: str) -> tuple:
    return () if name == "none" else (name,)


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = pc.chunk_rows(pc.make_corpus(args.total), args.chunk)
    nb = rows.shape[0] // args.batch
    rows = rows[: nb * args.batch]
    work = batches(rows, args.batch, dev)
    print(f"{nb} batches x {args.batch} chunks of {args.chunk} bytes; "
          f"{describe(dev)}", flush=True)
    base_ms = None
    for name in args.names or ABLATIONS:
        ab = ablation(name)

        def run_all():
            outs = [lean_pipeline(*b, ab) for b in work]
            sync(dev)
            return outs

        outs = run_all()
        dt = float("inf")
        for _ in range(args.passes):
            t0 = time.perf_counter()
            outs = run_all()
            dt = min(dt, time.perf_counter() - t0)
        ms = dt * 1000 / nb
        note = ""
        if name == "none":
            base_ms = ms
            w, t = outs[0][0][0].cpu(), int(outs[0][1][0])
            ok = zlib.decompressobj(-15).decompress(
                device_stream_to_bytes(w, t)) == rows[0].tobytes()
            note = "OK" if ok else "MISMATCH"
        elif base_ms is not None:
            note = f"marginal {base_ms - ms:8.2f} ms/batch"
        print(f"{name:12s} {rows.size / dt / 1e9:8.4f} GB/s "
              f"({ms:8.2f} ms/batch) {note}", flush=True)
        if note == "MISMATCH":
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
