"""Stage profile of the lean DP tier on the card.

Counterpart of ``scripts/profile_lean.py``: the same lines in the same
order (lines 57-161), each one of the port's own stage functions with the
script's arguments over a batch of B = 4 chunks of 1 MiB (this
repository's ``native/ldtpu_native.cpp`` repeated, where the script
repeats the reference's ``lib/deflate_compress.c``), each stage's output
the next one's input:

- candidates: ``pipeline.parse_candidates`` (depth 6, no content pass,
  16-byte payloads, C relaxed), the position pass alone (the sort and
  C5, ``probe_kernels.segment_probe``'s lean form) and the relaxation, C3
  (``chain_kernels.chain_extend_multi``), over three and two of its
  triples;
- costs: ``optimal.literal_costs_with`` and ``dist_cost`` x4;
- the DP, K1 (``kernels.dp_parse``), at 28, 46 and 80 rungs;
- the commit, C1 (``optimal.commit``);
- ``dynamic.emit_dynamic_pre`` (C2 inside) at refine 16, 4 and 0;
- ``pipeline.group_premerge`` at cap 61 and the pack, K2
  (``kernels.pack_groups``);
- the whole lean1J tier (``compress_chunks_optimal_pallas_with``).

Each line gives the median of ``--reps`` calls (5) by the host clock,
ending in ``torch.cuda.synchronize()``, and by CUDA events with the
card's queue filled before the call (``timing.stage_ms``): the two differ
where the host paces the stage, unless the stage itself waits for the
card (a count copied to the host), after which the host paces it again.
``--trace`` adds the device's busy time in one traced call
(``torch.profiler``).  Runs on CUDA (raising without it) unless
``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.profile_lean [--reps 5]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..compress import chain_kernels, kernels, probe_kernels
from ..compress.bits import to_i32
from ..compress.dynamic import (DYN_CAPW_DEEP, dyn_nwords, emit_dynamic_post,
                                emit_dynamic_pre)
from ..compress.optimal import (DP_SEG, SEED_LC_LEN, commit,
                                compress_chunks_optimal_pallas_with,
                                dist_cost, literal_costs_with)
from ..compress.pipeline import (_row_inputs, group_premerge,
                                 parse_candidates)
from ..device import resolve_device
from .driver_common import Bench, device_args, header, on_device, text_batch

CHUNK = 1 << 20
B = 4
REPS = 5
LADDERS = (("sparse28", kernels.LEN_LADDER),
           ("dense46", kernels.LEN_LADDER_DENSE),
           ("dense2_80", kernels.LEN_LADDER_DENSE2))


def posonly(bufs, lengths):
    """The position pass alone (the script's ``posonly``): the lean
    sorted matchfind's three raw triples over 16-byte payloads."""
    bp, _, _, _, h, sort_seg, _, _ = _row_inputs(bufs, lengths, True)
    return probe_kernels.segment_probe(h, bp, sort_seg, 6, 16, "lean")


def stages(bufs, lengths, bfinal, bench) -> dict:
    """The script's lines through ``bench``; returns the outputs by line
    name, and under "stream" the profiled chain's (words, total_bits)
    (refine 16, cap 61, the pack) closed by ``emit_dynamic_post``."""
    dev = bufs.device
    tiny = torch.ones(128, dtype=torch.int32, device=dev)
    bench("null floor (dispatch+sync)", lambda x: x * 2, tiny)
    cands = bench("_parse_candidates LEAN total",
                  lambda b, l: parse_candidates(
                      b, l, depth=6, two_pass=False, hash3=False,
                      wide_window=True, use_content=False, use_wide=False),
                  bufs, lengths)
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = cands
    raws = bench("  pos-pass sort (5 ops, triple)", posonly, bufs, lengths)
    bench("  chain_extend_multi x3", chain_kernels.chain_extend_multi,
          list(raws))
    bench("  chain_extend_multi x2 (no C)", chain_kernels.chain_extend_multi,
          list(raws[:2]))
    cost_lit = bench("_literal_costs (257-sym hist)",
                     lambda b, l: literal_costs_with(b, l)[0], bp, lengths)
    cd = bench("dist costs x4", lambda *ds: [dist_cost(d) for d in ds],
               dA, dB, dC, d3)
    lc_len = torch.as_tensor(SEED_LC_LEN, device=dev)
    for name, ladder in LADDERS:
        span, dist = bench(
            f"DP K1 [{name}]",
            lambda *a, _l=ladder: kernels.dp_parse(*a, DP_SEG, _l),
            cost_lit, lenA, dA, cd[0], lenB, dB, cd[1], lenC, dC, cd[2], d3,
            cd[3], lc_len)
    cm, cl, eff = bench("commit C1 (merge)",
                        lambda *a: commit(*a, DP_SEG), span, dist, pos,
                        lengths)
    for rp in (16, 4, 0):
        pre = bench(f"_emit_dynamic_pre refine={rp}",
                    lambda *a, _r=rp: emit_dynamic_pre(*a, _r),
                    bp, cm, cl, eff, dist, keep=rp == 16)
        if rp == 16:
            (val, nb, offs), aux = pre
    sbuf, gw = bench("_group_premerge cap61",
                     lambda v, n, o: group_premerge(v, n, o, DYN_CAPW_DEEP),
                     val, nb, offs)
    nwords = dyn_nwords(bufs.shape[1])
    words = bench("pack_groups K2", kernels.pack_groups, sbuf, gw, nwords)
    bench("FULL lean1J (p1, dense2)",
          lambda b, l, f: compress_chunks_optimal_pallas_with(
              b, l, f, device=dev, depth=6, two_pass=False, hash3=False,
              passes=1, use_content=False, use_wide=False,
              ladder=kernels.LEN_LADDER_DENSE2), bufs, lengths, bfinal)
    out = dict(bench.outputs)
    words, total_bits = emit_dynamic_post(words, aux, bfinal)
    out["stream"] = (to_i32(words), total_bits)
    return out


def run(dev: torch.device, batch: int = B, chunk: int = CHUNK,
        reps: int = REPS, log=print, trace: bool = False) -> dict:
    """The profile on dev: {"rows": the timed lines, "outputs": ...}."""
    header(dev, batch, chunk, reps, log)
    bufs, lengths, bfinal = on_device(text_batch(batch, chunk), dev)
    bench = Bench(dev, reps, batch, log=log)
    outputs = stages(bufs, lengths, bfinal, bench)
    if trace:
        bench.trace()
    return {"rows": bench.rows, "outputs": outputs, "bufs": bufs}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--trace", action="store_true",
                    help="also trace one call a line: the device's busy ms")
    args = ap.parse_args(argv)
    run(resolve_device(args.device), args.batch, args.chunk, args.reps,
        trace=args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
