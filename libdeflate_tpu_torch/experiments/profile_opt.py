"""Stage profile of the DP (opt) tier on the card.

Counterpart of ``scripts/profile_opt.py``: the same lines in the same
order (lines 62-218), each one of the port's own stage functions with the
script's arguments over a batch of B = 4 chunks of 1 MiB (this
repository's ``native/ldtpu_native.cpp`` repeated, where the script
repeats the reference's ``lib/deflate_compress.c``), each stage's output
the next one's input:

- candidates: the position pass with 32-byte payloads
  (``pipeline.sorted_matchfind_triple``), the content pass
  (``content_sorted_matchfind``, depth 4), the relaxation, C3
  (``chain_kernels.chain_extend_multi``), over five and three triples,
  and ``parse_candidates`` at its defaults;
- costs: ``optimal.literal_costs_with`` and ``dist_cost`` x4;
- the DP, K1 (``kernels.dp_parse``) at LEN_LADDER (``dp_parse_pallas``'s
  default ladder);
- the commit, C1 (``optimal.commit``), and ``code_lens_from_items`` (C2);
- ``dynamic.emit_dynamic_pre`` at refine 16 and 0;
- ``pipeline.group_premerge`` at caps 61 and 45, the pack, K2
  (``kernels.pack_groups``), and beside it K2's plain version
  ``kernels.group_place`` (where the script times XLA's
  ``_group_place``);
- the whole opt2, opt1 and dyn1 tiers.

Each line gives the median of ``--reps`` calls (5) by the host clock,
ending in ``torch.cuda.synchronize()``, and by CUDA events with the
card's queue filled before the call (``timing.stage_ms``); ``--trace``
adds the device's busy time in one traced call (``torch.profiler``).
Runs on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.profile_opt [--reps 5]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..compress import chain_kernels, kernels
from ..compress.bits import ahead, to_i32
from ..compress.dynamic import (DYN_CAPW, DYN_CAPW_DEEP,
                                compress_chunks_dynamic, dyn_nwords,
                                emit_dynamic_post, emit_dynamic_pre)
from ..compress.optimal import (DP_SEG, SEED_LC_LEN, code_lens_from_items,
                                commit, compress_chunks_optimal_pallas_with,
                                dist_cost, literal_costs_with)
from ..compress.kernels import group_place
from ..compress.pipeline import (_positions, content_sorted_matchfind,
                                 group_premerge, parse_candidates,
                                 sorted_matchfind_triple)
from ..device import resolve_device
from .driver_common import Bench, device_args, header, on_device, text_batch

CHUNK = 1 << 20
B = 4
REPS = 5
DEPTH = 6


def _inputs(bufs, lengths):
    (_, _, _, words, w4, w8, w12, h, sort_seg, _, _) = _positions(
        bufs, lengths, True)
    wide = tuple(ahead(words, k) for k in (16, 20, 24, 28))
    return words, w4, w8, w12, wide, h, sort_seg


def cand_posonly(bufs, lengths):
    """The position pass with 32-byte payloads (the script's
    ``cand_posonly``): three raw triples."""
    words, w4, w8, w12, wide, h, sort_seg = _inputs(bufs, lengths)
    return sorted_matchfind_triple(h, (words, w4, w8, w12) + wide, sort_seg,
                                   DEPTH)


def cand_content(bufs, lengths):
    """The content pass (the script's ``cand_content``): two raw
    triples."""
    words, w4, w8, w12, wide, h, sort_seg = _inputs(bufs, lengths)
    return content_sorted_matchfind(h, words, w4, w8, w12, sort_seg,
                                    max(DEPTH * 2 // 3, 4), wide)


def stages(bufs, lengths, bfinal, bench) -> dict:
    """The script's lines through ``bench``; returns the outputs by line
    name, and under "stream" the profiled chain's (words, total_bits)
    (refine 16, cap 61, the pack) closed by ``emit_dynamic_post``."""
    dev = bufs.device
    tiny = torch.ones(128, dtype=torch.int32, device=dev)
    bench("null floor (dispatch+sync)", lambda x: x * 2, tiny)
    raws = bench("pos-pass sort (9 ops, triple)", cand_posonly, bufs,
                 lengths)
    craw = bench("content pass (11 ops, 3 keys)", cand_content, bufs,
                 lengths)
    bench("chain_extend_multi x5", chain_kernels.chain_extend_multi,
          list(raws) + list(craw))
    bench("chain_extend_multi x3", chain_kernels.chain_extend_multi,
          list(raws))
    cands = bench("_parse_candidates total",
                  lambda b, l: parse_candidates(
                      b, l, depth=DEPTH, two_pass=False, hash3=False,
                      wide_window=True), bufs, lengths)
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = cands
    cost_lit = bench("_literal_costs (257-sym hist)",
                     lambda b, l: literal_costs_with(b, l)[0], bp, lengths)
    cd = bench("dist costs x4", lambda *ds: [dist_cost(d) for d in ds],
               dA, dB, dC, d3)
    lc_len = torch.as_tensor(SEED_LC_LEN, device=dev)
    span, dist = bench(
        "DP K1 [sparse28]",
        lambda *a: kernels.dp_parse(*a, DP_SEG, kernels.LEN_LADDER),
        cost_lit, lenA, dA, cd[0], lenB, dB, cd[1], lenC, dC, cd[2], d3,
        cd[3], lc_len)
    cm, cl, eff = bench("commit C1 (merge)",
                        lambda *a: commit(*a, DP_SEG), span, dist, pos,
                        lengths)
    bench("code_lens_from_items (C2, 316 syms)", code_lens_from_items,
          bp, cm, cl, eff, dist)
    (val, nb, offs), aux = bench(
        "_emit_dynamic_pre refine=16 cap15",
        lambda *a: emit_dynamic_pre(*a, 16), bp, cm, cl, eff, dist)
    bench("_emit_dynamic_pre refine=0 cap11",
          lambda *a: emit_dynamic_pre(*a, 0), bp, cm, cl, eff, dist)
    sbuf, gw = bench("_group_premerge cap61",
                     lambda v, n, o: group_premerge(v, n, o, DYN_CAPW_DEEP),
                     val, nb, offs)
    bench("_group_premerge cap45",
          lambda v, n, o: group_premerge(v, n, o, DYN_CAPW), val, nb, offs)
    nwords = dyn_nwords(bufs.shape[1])
    words = bench("pack_groups K2 cap61", kernels.pack_groups, sbuf, gw,
                  nwords)
    bench("group_place cap61 (K2's plain version)", group_place, sbuf, gw,
          nwords)
    for name, passes in (("FULL opt2-pallas", 2),
                         ("FULL opt1-pallas (passes=1)", 1)):
        bench(name, lambda b, l, f, _p=passes:
              compress_chunks_optimal_pallas_with(
                  b, l, f, device=dev, depth=DEPTH, two_pass=False,
                  hash3=False, passes=_p), bufs, lengths, bfinal)
    bench("FULL dyn1-pallas",
          lambda b, l, f: compress_chunks_dynamic(b, l, f, device=dev),
          bufs, lengths, bfinal)
    out = dict(bench.outputs)
    words, total_bits = emit_dynamic_post(words, aux, bfinal)
    out["stream"] = (to_i32(words), total_bits)
    return out


def run(dev: torch.device, batch: int = B, chunk: int = CHUNK,
        reps: int = REPS, log=print, trace: bool = False) -> dict:
    """The profile on dev: {"rows": the timed lines, "outputs": ...}."""
    header(dev, batch, chunk, reps, log)
    bufs, lengths, bfinal = on_device(text_batch(batch, chunk), dev)
    bench = Bench(dev, reps, batch, width=42, log=log)
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
