"""C1 and C2, the compress paths' loop kernels, beside an earlier tree's
on the card, in turns.

``csrc/commit_fsm.cu`` (C1) and ``csrc/code_lens.cu`` (C2) of this tree
are built as they stand, and with ``--against DIR`` the same two files of
DIR (an earlier checkout with the same C interfaces, such as ``git
archive`` of the parent commit unpacked where ``.gitignore`` lists it) as
"parent", each by ``nvcc`` into ``build/variants/`` (named by content,
``harness.build_tagged``).
The inputs are the kernels' own on the main paths: the commit of one
``compress_chunks_lean`` call (seg 1024) and of one
``compress_chunks_dynamic`` call (seg 512), and the code-length builds of
that lean call (8 rows, refine 0, 11 bits) and of one
``compress_chunks_optfast`` call (its refine-16, 15-bit build), each on
the first B = 4 x 1 MiB batch of ``chip_smoke.py``'s 16 MiB corpus.
Every build is checked against the plain versions
(``scan_kernels.greedy_commit_merge``, ``build_code_lens``) on those
inputs and on ``experiments/crafted_scan.py``'s sets, then each bare
launch is timed in turns (this tree, parent, parent, this tree), by CUDA
graph replay (the card's time) and by CUDA events around back-to-back
launches (the host's pace when a launch costs it more than the kernel
takes).

    python -m libdeflate_tpu_torch.experiments.scan_variants [--against DIR]

Needs a CUDA card and ``nvcc``.  Prints one JSON object a line: the card,
the builds' register, shared-memory and spill lines, the checks, the
times, and last all of them with the card's name and power limit.
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
from ..compress import dynamic, optimal, scan_kernels
from . import crafted_scan
from .corpus import make_corpus
from .harness import build_tagged, record_calls
from .timing import cuda_ms, graph_ms

CHUNK = 1 << 20
BATCH = 4
CORPUS_MB = 16      # chip_smoke.py's corpus; the inputs are its first batch
ROOT = Path(__file__).resolve().parents[2]
KERNELS = {"commit_fsm": ("commit_fsm_launch", "PPPPPIIP"),
           "code_lens": ("code_lens_launch", "PPPIIIIP")}
THIS = "this tree"
PARENT = "parent"


def build_all(against: Path | None) -> tuple[dict, dict]:
    """Build both kernels of this tree (and of the tree ``against``),
    every nvcc started together: ({(tree, kernel): launch function},
    {(tree, kernel): build lines})."""
    trees = {THIS: _build.SRC_DIR}
    if against is not None:
        trees[PARENT] = Path(against) / "libdeflate_tpu_torch" / "csrc"
    libs, lines = build_tagged({
        (tree, name): (name, (src_dir / f"{name}.cu").read_text())
        for tree, src_dir in trees.items() for name in KERNELS})
    fns = {}
    types = {"P": _build.PTR, "I": _build.INT}
    for (tree, name), lib in libs.items():
        fn_name, sig = KERNELS[name]
        fn = lib[fn_name]      # a function object of its own
        fn.argtypes = [types[c] for c in sig]
        fn.restype = ctypes.c_int
        fns[tree, name] = fn
    return fns, lines


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launcher(fns: dict, tree: str, name: str, args: tuple):
    """(a function that launches the build of ``tree`` on ``args`` into
    fixed outputs, the outputs)."""
    fn = fns[tree, name]
    if name == "commit_fsm":
        span, is_match, dist, seg = args
        outs = (torch.empty_like(is_match), torch.empty_like(span))
        call = (_p(span), _p(is_match), _p(dist), _p(outs[0]), _p(outs[1]),
                seg, span.numel() // seg)
        tensors = (span, is_match, dist) + outs
    else:
        hist, refine, max_len = args
        outs = (torch.empty_like(hist),
                torch.empty(hist.shape[0], dtype=torch.bool,
                            device=hist.device))
        call = (_p(hist), _p(outs[0]), _p(outs[1]), hist.shape[0],
                hist.shape[1], refine, max_len)
        tensors = (hist,) + outs

    def run():
        with _build.launch_context(tensors, f"{name} ({tree})") as stream:
            err = fn(*call, stream)
        if err:
            raise RuntimeError(f"{name} ({tree}) failed to launch: {err}")
    return run, outs


def plain(name: str, args: tuple):
    """The plain version on the CPU (its loops of small torch ops run
    faster there than as launches)."""
    args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    if name == "commit_fsm":
        return scan_kernels.greedy_commit_merge(*args)
    return scan_kernels.build_code_lens(*args)


def main_path_inputs(dev: torch.device) -> dict:
    """{(kernel, set name): args} from one call of each entry on the
    corpus's first batch."""
    corpus = make_corpus(CORPUS_MB << 20, ROOT)[:BATCH * CHUNK]
    b = torch.as_tensor(np.frombuffer(corpus, np.uint8).reshape(BATCH, CHUNK)
                        .copy(), device=dev)
    lengths = torch.full((BATCH,), CHUNK, dtype=torch.int64, device=dev)
    bfinal = torch.ones(BATCH, dtype=torch.bool, device=dev)
    out = {}
    for tier, entry in (("lean", optimal.compress_chunks_lean),
                        ("dyn1", dynamic.compress_chunks_dynamic)):
        out["commit_fsm", tier] = record_calls(
            scan_kernels, "commit_fsm",
            lambda: entry(b, lengths, bfinal))[1][0]
    out["code_lens", "lean"] = record_calls(
        scan_kernels, "code_lens",
        lambda: optimal.compress_chunks_lean(b, lengths, bfinal))[1][0]
    builds = record_calls(
        scan_kernels, "code_lens",
        lambda: optimal.compress_chunks_optfast(b, lengths, bfinal))[1]
    out["code_lens", "optfast"] = next(a for a in builds if a[1] == 16)
    return out


def crafted_inputs(dev: torch.device) -> dict:
    out = {}
    for name, arrs in crafted_scan.commit_sets().items():
        t = tuple(torch.as_tensor(a, device=dev) for a in arrs)
        for seg in crafted_scan.COMMIT_SEGS:
            out["commit_fsm", f"crafted: {name}, seg {seg}"] = t + (seg,)
    for name, (*arrs, seg) in crafted_scan.commit_long_sets().items():
        out["commit_fsm", f"crafted: {name}"] = tuple(
            torch.as_tensor(a, device=dev) for a in arrs) + (seg,)
    hists = dict(crafted_scan.hist_sets())
    hists.update(crafted_scan.hist_sets_other())
    for name, hist in hists.items():
        for cfg in crafted_scan.CODE_LENS_CFGS:
            out["code_lens", f"crafted: {name}, {cfg}"] = (
                torch.as_tensor(hist, device=dev), *cfg)
    return out


def main(against: Path | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("scan_variants measures the card: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "card": card}), flush=True)
    fns, lines = build_all(against)
    trees = [THIS] + ([PARENT] if against is not None else [])
    out = {"card": card, "build": {f"{t}, {n}": v
                                   for (t, n), v in lines.items()}}
    print(json.dumps({"build": out["build"]}), flush=True)
    main_sets = main_path_inputs(dev)
    sets = dict(main_sets)
    sets.update(crafted_inputs(dev))
    equal = {}
    for (name, sname), args in sets.items():
        want = plain(name, args)
        for tree in trees:
            run, outs = launcher(fns, tree, name, args)
            run()
            equal[f"{name}, {sname}, {tree}"] = all(
                torch.equal(a.cpu(), w.cpu()) for a, w in zip(outs, want))
    out["equal"] = equal
    out["all_equal"] = all(equal.values())
    print(json.dumps({"checked": len(equal), "all_equal": out["all_equal"],
                      "unequal": [k for k, v in equal.items() if not v]}),
          flush=True)
    order = trees + trees[::-1]
    ms = {}
    for (name, sname), args in main_sets.items():
        row = ms[f"{name}, {sname}"] = {"shape": list(args[0].shape),
                                        "args": [a for a in args[1:]
                                                 if isinstance(a, int)]}
        # (run, outputs): the outputs stay alive while their run is timed
        runs = {tree: launcher(fns, tree, name, args) for tree in trees}
        for tree in order:
            row.setdefault(f"{tree}, graph", []).append(
                graph_ms(runs[tree][0], 50))
            row.setdefault(f"{tree}, events", []).append(
                cuda_ms(runs[tree][0], 50))
        print(json.dumps({f"{name}, {sname}": row}), flush=True)
    out["ms"] = ms
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if not out["all_equal"]:
        raise AssertionError("a build disagrees with the plain version")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(Path(argv[argv.index("--against") + 1])
         if "--against" in argv else None)
