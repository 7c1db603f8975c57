"""K1's design choices measured on the card.

``csrc/dp_parse.cu`` is built once as it stands and once for each variant
with a constant or a line substituted: the group size (threads a lane,
``kGroup``) and the warps a block (``kWarps``), and two diagnostics that
are not the DP: "one rung a thread" (each thread keeps its first rung
only, so the rest is the kernel without its rung work) and "no input
loads" (positions made from their index instead of read). Every variant
that computes the DP is held to the plain version; each is timed as its
bare launch by CUDA events, in turns (the list, then the list reversed),
on the JAX test generator's inputs and on the main path's four batches
of the corpus at 4 x 1 MiB, S = 1024, on LEN_LADDER_DENSE2 (the lean
tier's ladder); the as-built kernel is also timed on the same inputs at
LEN_LADDER.

    python -m libdeflate_tpu_torch.experiments.dp_variants [--against F]

``--against F`` adds the ``dp_parse.cu`` at path F (an earlier version,
whose launch function has no ladder argument and computes the dense
ladder) as one more variant, checked and timed in the same turns: the
way to hold a change of the kernel to its parent on one card.

Needs a CUDA card and ``nvcc``.  Prints one JSON object a line: the card,
the build logs' register and spill lines, the checks, then the times.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..compress import kernels, optimal, pipeline
from .corpus import make_corpus
from .crafted_dp import random_inputs
from .harness import build_tagged
from .timing import cuda_ms, describe

CHUNK = 1 << 20
BATCH = 4
ROOT = Path(__file__).resolve().parents[2]

# name -> {constant: value} substituted into dp_parse.cu
VARIANTS = {
    "G8 W4 (as built)": {},
    "G4 W4": {"kGroup": 4},
    "G16 W4": {"kGroup": 16},
    "G8 W2": {"kWarps": 2},
    "G8 W8": {"kWarps": 8},
    "G16 W8": {"kGroup": 16, "kWarps": 8},
}
# name -> (line, replacement): not the DP, so not checked
DIAGNOSTICS = {
    "one rung a thread": ("for (int k = 1; k < Sh::kPer; ++k)",
                          "for (int k = 1; k < 1; ++k)"),
    "no input loads": ("raw[r][a] = ok ? __ldg(in.a[a] + at) : 0;",
                       "raw[r][a] = ok ? (long long)(at & 7) : 0;"),
}


def variant_source(src: str, name: str) -> str:
    """dp_parse.cu with the variant's or diagnostic's substitution; each
    must match exactly once."""
    if name in DIAGNOSTICS:
        old, new = DIAGNOSTICS[name]
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in dp_parse.cu once")
        return src.replace(old, new)
    for const, value in VARIANTS[name].items():
        pat = rf"constexpr int {const} = \d+;"
        if len(re.findall(pat, src)) != 1:
            raise ValueError(f"{name}: {const} is not in dp_parse.cu once")
        src = re.sub(pat, f"constexpr int {const} = {value};", src)
    return src


def build_all(names, against: Path | None = None) -> tuple[dict, dict]:
    """Build every named variant (and the source ``against`` as
    "against"), all nvcc started together: (launch function per name,
    register and spill lines per name).  A launch function takes
    ``launch``'s arguments."""
    src = (_build.SRC_DIR / "dp_parse.cu").read_text()
    sources = {name: ("dp_parse", variant_source(src, name))
               for name in names}
    if against is not None:
        sources["against"] = ("dp_parse", Path(against).read_text())
    libs, regs = build_tagged(sources)
    fns = {}
    for name, lib in libs.items():
        fn = lib["dp_parse_launch"]   # a function object of its own
        P, I = _build.PTR, _build.INT
        # an earlier source's launch function has no ladder argument
        fn.argtypes = [P] * 13 + [I, I, P, P, I, I, I] + (
            [P] if name == "against" else [I, P])
        fn.restype = ctypes.c_int
        fn.takes_ladder = name != "against"
        fns[name] = fn
    return fns, regs


def launch(fn, args, S: int, span, dist,
           ladder=kernels.LEN_LADDER_DENSE2) -> None:
    """The bare launch of one build on dp_parse's thirteen arguments."""
    arrs, lc = args[:12], args[12]
    B, n_pad = arrs[0].shape

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    rungs = [kernels.ladder_rungs(ladder)] if fn.takes_ladder else []
    with _build.launch_context(tuple(arrs) + (lc, span, dist),
                               "dp_parse variant") as stream:
        err = fn(*map(ptr, arrs), ptr(lc), int(lc.dtype == torch.int64),
                 1 if lc.dim() == 1 else B, ptr(span), ptr(dist), S,
                 B * (n_pad // S), n_pad // S, *rungs, stream)
    if err:
        raise RuntimeError(f"dp_parse variant failed to launch: {err}")


def main_path_dp_inputs(bufs, lengths):
    """dp_parse's arguments for one batch, from the stage functions that
    compress_chunks_lean calls."""
    bp, _, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(bufs, lengths)
    cost_lit = optimal.literal_costs(
        bp, lengths, optimal.literal_cost_table(bp, lengths))
    dc = optimal.dist_cost
    return (cost_lit, lenA, dA, dc(dA), lenB, dB, dc(dB), lenC, dC, dc(dC),
            d3, dc(d3), torch.as_tensor(optimal.SEED_LC_LEN,
                                        device=bp.device))


def main(against: Path | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("dp_variants measures the card: no CUDA device")
    dev = torch.device("cuda", 0)
    names = list(VARIANTS) + list(DIAGNOSTICS)
    fns, regs = build_all(names, against)
    checked = list(VARIANTS) + (["against"] if against else [])
    names = names + (["against"] if against else [])
    corpus = make_corpus(4 * BATCH * CHUNK, ROOT)
    chunks = np.frombuffer(corpus, np.uint8).reshape(-1, CHUNK)
    lengths = torch.full((BATCH,), CHUNK, dtype=torch.int64, device=dev)
    inputs = {"random": random_inputs(dev)}
    for k in range(len(chunks) // BATCH):
        inputs[f"main path batch {k}"] = main_path_dp_inputs(
            torch.as_tensor(chunks[BATCH * k:BATCH * (k + 1)].copy(),
                            device=dev), lengths)
    S = optimal.DP_SEG
    span = torch.empty(BATCH, CHUNK, dtype=torch.int64, device=dev)
    dist = torch.empty_like(span)
    out = {"device": describe(dev), "registers": regs, "equal": {}, "ms": {}}
    print(json.dumps({"device": out["device"]}), flush=True)
    print(json.dumps({"registers": regs}), flush=True)
    built = fns["G8 W4 (as built)"]
    for iname, args in inputs.items():
        want = kernels.dp_parse_plain(*args, S)
        for name in checked:
            launch(fns[name], args, S, span, dist)
            out["equal"][f"{iname}, {name}"] = bool(
                torch.equal(span, want[0]) and torch.equal(dist, want[1]))
        want = kernels.dp_parse_plain(*args, S, kernels.LEN_LADDER)
        launch(built, args, S, span, dist, kernels.LEN_LADDER)
        out["equal"][f"{iname}, as built, LEN_LADDER"] = bool(
            torch.equal(span, want[0]) and torch.equal(dist, want[1]))
    print(json.dumps({"equal": out["equal"]}), flush=True)
    for iname, args in inputs.items():
        row = out["ms"][iname] = {}
        for name in names + names[::-1]:
            row.setdefault(name, []).append(cuda_ms(
                lambda: launch(fns[name], args, S, span, dist), 20))
            if name == "G8 W4 (as built)":
                row.setdefault("as built, LEN_LADDER", []).append(cuda_ms(
                    lambda: launch(built, args, S, span, dist,
                                   kernels.LEN_LADDER), 20))
        print(json.dumps({"ms": {iname: row}}), flush=True)
    if not all(out["equal"].values()):
        raise AssertionError("a dp_parse variant disagrees with the plain "
                             "version")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(Path(argv[argv.index("--against") + 1])
         if "--against" in argv else None)
