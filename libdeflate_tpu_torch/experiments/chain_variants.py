"""C3 and C4, the candidates' chain extension, beside an earlier tree's
on the card, in turns.

``csrc/chain_extend.cu`` of this tree is built as it stands ("this
tree"), with ``CHAIN_CLOCK`` (the clock64() phase probe), and with
``--against DIR`` the same file of DIR (an earlier checkout with the
same C interfaces, such as ``git archive`` of the parent commit, or of
a commit that holds a design to compare, unpacked where ``.gitignore``
lists it) as "parent", each by ``nvcc`` into ``build/variants/`` (named
by content, ``harness.build_tagged``).
The inputs are the kernels' own on the main paths, recorded from one
call of each entry on the first B = 4 x 1 MiB batch of
``chip_smoke.py``'s 16 MiB corpus: lean's C3 (K = 2, one round of 8
strides), optimal's (K = 5, two rounds), dyn1's C4 (one candidate) and
dyn2's (two); and the scripts' K = 3 triples (``profile_lean``'s x3,
two rounds).  Every build is checked against the plain versions
(``chain_kernels.chain_extend_multi_plain``, ``chain_extend_plain``,
``chain_extend2_plain`` on the card) on those inputs and on
``experiments/crafted_chain.py``'s sets (K = 2, 3, 5 at one and two
default rounds, C4's one and two candidates, the walk's shapes) at tiles
64, 256 and the wrappers' 1024;
then each bare launch at the wrappers' tile is timed in turns (this
tree, parent, parent, this tree), by CUDA graph replay (the card's
time) and by CUDA events around back-to-back launches.
Last, the probe build's cycles a block in its prologue, loads, steps
and stores on each main input.

    python -m libdeflate_tpu_torch.experiments.chain_variants \\
        [--against DIR]

Needs a CUDA card and ``nvcc``.  Prints one JSON object a line: the card,
the builds' register, shared-memory and spill lines, the checks, the
times, the phase split, and last all of them with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..compress import chain_kernels, dynamic, optimal
from ..compress.bits import STRIDES
from . import crafted_chain, profile_lean
from .corpus import make_corpus
from .harness import build_tagged, record_calls
from .timing import cuda_ms, graph_ms

CHUNK = 1 << 20
BATCH = 4
CORPUS_MB = 16      # chip_smoke.py's corpus; the inputs are its first batch
ROOT = Path(__file__).resolve().parents[2]
THIS = "this tree"
PARENT = "parent"
PROBE = "clock64() probe"
TILES = (64, 256, chain_kernels.TILE)   # the checks'; times at the last
# each main input: (entry, the wrapper it calls, the kernel)
MAIN = {"lean": (optimal.compress_chunks_lean, "chain_extend_multi"),
        "optimal": (optimal.compress_chunks_optimal, "chain_extend_multi"),
        "dyn1": (dynamic.compress_chunks_dynamic, "chain_extend"),
        "dyn2": (dynamic.compress_chunks_dynamic2, "chain_extend2")}
PHASES = ("prologue", "loads", "steps", "stores")


def parse_args(argv) -> Path | None:
    """--against DIR, or None."""
    args = list(argv)
    if not args:
        return None
    if len(args) == 2 and args[0] == "--against":
        return Path(args[1])
    raise SystemExit(__doc__)


def build_all(against: Path | None) -> tuple[dict, dict]:
    """Build this tree's source, the probe and (with ``against``) the
    parent's, every nvcc started together: ({(build, C function name):
    function}, {build: build lines})."""
    src = (_build.SRC_DIR / "chain_extend.cu").read_text()
    sources = {THIS: ("chain_extend", src),
               PROBE: ("chain_extend", "#define CHAIN_CLOCK 1\n" + src)}
    if against is not None:
        sources[PARENT] = ("chain_extend", (
            Path(against) / "libdeflate_tpu_torch" / "csrc" /
            "chain_extend.cu").read_text())
    libs, lines = build_tagged(sources)
    P, I = _build.PTR, _build.INT
    fns = {}
    for build, lib in libs.items():
        for fn_name, types in (
                ("chain_relax_launch", [P, P, I, I, I, P, I, I, P]),
                ("chain_double_launch", [P, P, I, I, I, I, P])):
            fn = lib[fn_name]      # a function object of its own
            fn.argtypes = types
            fn.restype = ctypes.c_int
            fns[build, fn_name] = fn
    take = libs[PROBE]["chain_clock_take"]
    take.argtypes = [P]
    take.restype = ctypes.c_int
    fns[PROBE, "chain_clock_take"] = take
    return fns, lines


def split(name: str, args: tuple):
    """(the candidates' triples, the strides (strides1 then strides2) or
    None for C4) of a wrapper ``name``'s positional arguments."""
    if name == "chain_extend_multi":
        s2 = args[1] if len(args) > 1 else STRIDES
        s1 = args[2] if len(args) > 2 else STRIDES
        return [tuple(c) for c in args[0]], tuple(s1) + tuple(s2)
    return [tuple(args[3 * i:3 * i + 3]) for i in range(len(args) // 3)], \
        None


def plain(name: str, args: tuple) -> list:
    """The plain version's result as a flat list of tensors."""
    out = getattr(chain_kernels, name + "_plain")(*args)
    if name == "chain_extend_multi":
        return [x for pair in out for x in pair]
    return list(out)


def launcher(fns: dict, build: str, name: str, args: tuple,
             tile: int = chain_kernels.TILE):
    """(a function that launches ``build``'s kernel on the wrapper
    ``name``'s arguments into fixed outputs, the outputs as the plain
    version returns them)."""
    cands, strides = split(name, args)
    flat = [x for c in cands for x in c]
    n = flat[0].shape[-1]
    rows = flat[0].numel() // n
    outs = [torch.empty_like(c[0]) for c in cands]
    ins_p = (ctypes.c_void_p * len(flat))(*(t.data_ptr() for t in flat))
    outs_p = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
    if strides is not None:
        fn = fns[build, "chain_relax_launch"]
        st = (ctypes.c_int * max(len(strides), 1))(*strides)
        call = (ins_p, outs_p, len(cands), rows, n, st, len(strides), tile)
        result = [x for o, c in zip(outs, cands) for x in (o, c[1])]
    else:
        fn = fns[build, "chain_double_launch"]
        call = (ins_p, outs_p, len(cands), rows, n, tile)
        result = outs if len(cands) == 2 else [outs[0], cands[0][1]]

    def run():
        with _build.launch_context(flat + outs, f"{name} ({build})") as s:
            err = fn(*call, s)
        if err:
            raise RuntimeError(f"{name} ({build}) failed to launch: {err}")
    return run, result


def record_inputs(bufs, lengths, bfinal, device=None) -> dict:
    """{tier: (wrapper name, its positional arguments)}: the first call of
    each MAIN entry's chain extension on one batch (uint8 [B, N], int64
    [B] and bool [B] tensors on ``device``), and the scripts' K = 3
    triples (``profile_lean``'s x3, two default rounds)."""
    out = {}
    for tier, (entry, name) in MAIN.items():
        seen = record_calls(chain_kernels, name,
                            lambda: entry(bufs, lengths, bfinal, device))[1]
        out[tier] = (name, seen[0])
    out["profile_lean x3"] = ("chain_extend_multi",
                              (list(profile_lean.posonly(bufs, lengths)),))
    return out


def main_path_inputs(dev: torch.device) -> dict:
    corpus = make_corpus(CORPUS_MB << 20, ROOT)[:BATCH * CHUNK]
    b = torch.as_tensor(np.frombuffer(corpus, np.uint8).reshape(BATCH, CHUNK)
                        .copy(), device=dev)
    lengths = torch.full((BATCH,), CHUNK, dtype=torch.int64, device=dev)
    bfinal = torch.ones(BATCH, dtype=torch.bool, device=dev)
    return record_inputs(b, lengths, bfinal)


def crafted_inputs(dev: torch.device) -> dict:
    """{set name: (wrapper name, arguments)} of crafted_chain's sets."""
    cc = crafted_chain
    out = {}

    def dev_cands(cands):
        return [tuple(torch.as_tensor(x, device=dev) for x in c)
                for c in cands]

    for K in cc.RELAX_KS:
        sets = dict(cc.relax_sets(K))
        sets.update(cc.relax_shape_sets(K))
        for set_name, cands in sets.items():
            for rounds in ("one default round (lean)", "two default rounds"):
                s1, s2 = cc.STRIDE_SETS[rounds]
                out[f"C3 K = {K}, {set_name}, {rounds}"] = (
                    "chain_extend_multi", (dev_cands(cands), s2, s1))
    for nc, name in ((1, "chain_extend"), (2, "chain_extend2")):
        sets = dict(cc.double_sets(nc))
        sets.update(cc.double_shape_sets(nc))
        for set_name, cands in sets.items():
            out[f"C4 {nc}, {set_name}"] = (
                name, tuple(x for c in dev_cands(cands) for x in c))
    return out


def clock_split(fns: dict, name: str, args: tuple) -> dict:
    """The probe's cycles a block in each phase, over 5 launches."""
    take = fns[PROBE, "chain_clock_take"]
    cyc = (ctypes.c_longlong * 5)()
    run, _ = launcher(fns, PROBE, name, args)
    run()
    _build_check(take(cyc), "chain_clock_take")
    for _ in range(5):
        run()
    _build_check(take(cyc), "chain_clock_take")
    blocks = max(cyc[4], 1)
    total = sum(cyc[i] for i in range(4))
    return {"blocks": cyc[4] // 5,
            **{f"{p} cycles a block": cyc[i] / blocks
               for i, p in enumerate(PHASES)},
            **{f"{p} share": cyc[i] / max(total, 1)
               for i, p in enumerate(PHASES)}}


def _build_check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def main(against: Path | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chain_variants measures the card: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "card": card}), flush=True)
    fns, lines = build_all(against)
    builds = [THIS] + ([PARENT] if against is not None else [])
    out = {"card": card, "build": lines}
    print(json.dumps({"build": lines}), flush=True)
    main_sets = main_path_inputs(dev)
    sets = {f"{tier}'s inputs": v for tier, v in main_sets.items()}
    sets.update(crafted_inputs(dev))
    equal = {}
    for sname, (name, args) in sets.items():
        want = plain(name, args)
        for build in builds + [PROBE]:
            for tile in TILES:
                run, got = launcher(fns, build, name, args, tile)
                run()
                equal[f"{sname}, {build}, tile {tile}"] = all(
                    torch.equal(g, w) for g, w in zip(got, want))
    out["all_equal"] = all(equal.values())
    out["checked"] = len(equal)
    out["unequal"] = [k for k, v in equal.items() if not v]
    print(json.dumps({"checked": len(equal), "all_equal": out["all_equal"],
                      "unequal": out["unequal"]}), flush=True)
    order = builds + builds[::-1]
    ms = {}
    for tier, (name, args) in main_sets.items():
        cands, strides = split(name, args)
        row = ms[tier] = {"shape": list(cands[0][0].shape),
                          "K": len(cands),
                          "strides": list(strides) if strides else None}
        # (run, outputs): the outputs stay alive while their run is timed
        runs = {b: launcher(fns, b, name, args) for b in builds}
        for b in order:
            row.setdefault(f"{b}, graph", []).append(
                graph_ms(runs[b][0], 50))
            row.setdefault(f"{b}, events", []).append(
                cuda_ms(runs[b][0], 50))
        print(json.dumps({tier: row}), flush=True)
    out["ms"] = ms
    out["clock64"] = {}
    for tier, (name, args) in main_sets.items():
        out["clock64"][tier] = clock_split(fns, name, args)
        print(json.dumps({f"clock64, {tier}": out["clock64"][tier]}),
              flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if not out["all_equal"]:
        raise AssertionError("a build disagrees with the plain version")
    return out


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
