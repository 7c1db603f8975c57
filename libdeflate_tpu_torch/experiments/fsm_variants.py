"""F1's design choices, and an earlier F1, measured on the card.

``csrc/fsm_decode.cu`` is built once as it stands and once for each
variant with a constant or a line substituted: the litlen root at 10
bits (``kLLR``), the offset root at 8 (``kOFR``), no literal pairs in
the litlen root, and "compare only" (every root entry 0, so every lookup
takes the 15-length compare: the root tables undone, the input ring and
the output window kept).  Every variant computes the same function.
Each decodes the 16 zlib level-6 streams and the 16 lean-tier streams of
the corpus in one B = 16 call into 1 MiB rows; each must equal the plain
version on the zlib-6 set and the as-built kernel on the lean set, and
each is timed by CUDA events (a warm-up call, then the mean of 3) in
turns: the list, then the list reversed.

    python -m libdeflate_tpu_torch.experiments.fsm_variants [--against F]

``--against F`` adds the ``fsm_decode.cu`` at path F (an earlier version
with the same C interface, e.g. ``git show HEAD:libdeflate_tpu_torch/
csrc/fsm_decode.cu > .probe/parent_fsm_decode.cu``) as "against", checked
and timed in the same turns: the way to hold a change of the kernel to its
parent on one card.  ``chip_smoke.py --against F`` times the parent the
same way beside the as-built kernel.

Needs a CUDA card and ``nvcc``.  Prints one JSON object a line: the card,
the build logs' register, shared-memory and spill lines, the checks, then
the times.
"""

from __future__ import annotations

import ctypes
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..compress import optimal
from ..decompress import fsm
from .corpus import make_corpus
from .harness import build_tagged
from .timing import cuda_ms, describe

CHUNK = 1 << 20
BATCH = 4
ROOT = Path(__file__).resolve().parents[2]
AS_BUILT = "as built"

# name -> the (text, replacement) substitutions into fsm_decode.cu; every
# variant computes the same function
VARIANTS = {
    AS_BUILT: [],
    "litlen root 10": [("kLLR = 11", "kLLR = 10")],
    "offset root 8": [("kOFR = 10", "kOFR = 8")],
    "no literal pairs": [("pair_literals(sm.ll_root, lane);", ""),
                         ("pair_literals(sm.st_ll_root, lane);", "")],
    "compare only": [("root[w] = ln ? make_entry(",
                      "root[w] = 0 ? make_entry(")],
}


def variant_source(src: str, name: str) -> str:
    """fsm_decode.cu with the variant's substitutions; each must match
    exactly once."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in fsm_decode.cu once")
        src = src.replace(old, new)
    return src


def build_all(names, against: Path | None = None) -> tuple[dict, dict]:
    """Build every named variant (and the source ``against`` as
    "against"), all nvcc started together: (launch function per name,
    build lines per name)."""
    src = (_build.SRC_DIR / "fsm_decode.cu").read_text()
    sources = {name: ("fsm_decode", variant_source(src, name))
               for name in names}
    if against is not None:
        sources["against"] = ("fsm_decode", Path(against).read_text())
    libs, lines = build_tagged(sources)
    fns = {}
    for name, lib in libs.items():
        fn = lib.fsm_decode_launch
        P, I = _build.PTR, _build.INT
        fn.argtypes = [P, I, I, P, I, P, P, P, P, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, lines


def launch(fn, bufs: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """One call of a build, as ``fsm.decompress_chunks`` makes it: (out,
    out_lens, consumed, result)."""
    B, N = bufs.shape
    out = torch.empty(B, out_cap, dtype=torch.uint8, device=bufs.device)
    res = torch.empty(3, B, dtype=torch.int32, device=bufs.device)
    p = ctypes.c_void_p
    with _build.launch_context((bufs, lens, out, res),
                               "fsm_decode build") as stream:
        err = fn(p(bufs.data_ptr()), B, N, p(lens.data_ptr()), out_cap,
                 p(out.data_ptr()), p(res[0].data_ptr()),
                 p(res[1].data_ptr()), p(res[2].data_ptr()), stream)
    if err:
        raise RuntimeError(f"fsm_decode build failed to launch: {err}")
    return out, res[0], res[1], res[2]


def equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def in_turns(fns: dict, sets: dict, out_cap: int, reps: int = 3) -> dict:
    """{set: {build: [ms, ms]}}: each build timed on each set by CUDA
    events, in turns (the builds in order, then reversed)."""
    names = list(fns)
    out = {}
    for sname, (bufs, lens) in sets.items():
        row = out[sname] = {}
        for name in names + names[::-1]:
            row.setdefault(name, []).append(cuda_ms(
                lambda: launch(fns[name], bufs, lens, out_cap), reps))
    return out


def corpus_sets(dev: torch.device) -> dict:
    """{"zlib-6": (bufs, lens), "lean": (bufs, lens)}: the corpus's 16
    chunks as zlib level-6 streams (memLevel 9) and as lean-tier streams,
    one row each, on the card."""
    corpus = make_corpus(16 * CHUNK, ROOT)
    chunks = np.frombuffer(corpus, np.uint8).reshape(-1, CHUNK)
    streams = []
    for c in chunks:
        z = zlib.compressobj(6, zlib.DEFLATED, -15, 9)
        streams.append(z.compress(c.tobytes()) + z.flush())
    zb = np.zeros((len(streams), max(map(len, streams))), np.uint8)
    for k, s in enumerate(streams):
        zb[k, :len(s)] = np.frombuffer(s, np.uint8)
    zl = np.array([len(s) for s in streams], np.int32)
    lengths = torch.full((BATCH,), CHUNK, dtype=torch.int64, device=dev)
    bfinal = torch.ones(BATCH, dtype=torch.bool, device=dev)
    words, bits = zip(*(optimal.compress_chunks_lean(
        torch.as_tensor(chunks[i:i + BATCH].copy(), device=dev), lengths,
        bfinal) for i in range(0, len(chunks), BATCH)))
    return {"zlib-6": (torch.as_tensor(zb, device=dev),
                       torch.as_tensor(zl, device=dev)),
            "lean": (torch.cat(words).view(torch.uint8).contiguous(),
                     ((torch.cat(bits) + 7) // 8).to(torch.int32))}


def main(against: Path | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("fsm_variants measures the card: no CUDA device")
    dev = torch.device("cuda", 0)
    fns, lines = build_all(list(VARIANTS), against)
    out = {"device": describe(dev), "build": lines, "equal": {}}
    print(json.dumps({"device": out["device"]}), flush=True)
    print(json.dumps({"build": lines}), flush=True)
    sets = corpus_sets(dev)
    zb, zl = sets["zlib-6"]
    want = fsm.decode_chunks_fsm_plain(zb.cpu(), zl.cpu(), CHUNK)
    lb, ll = sets["lean"]
    ref = launch(fns[AS_BUILT], lb, ll, CHUNK)
    for name, fn in fns.items():
        out["equal"][f"zlib-6, {name}"] = equal(launch(fn, zb, zl, CHUNK),
                                                want)
        out["equal"][f"lean, {name}"] = equal(launch(fn, lb, ll, CHUNK), ref)
    print(json.dumps({"equal": out["equal"]}), flush=True)
    out["ms"] = in_turns(fns, sets, CHUNK)
    print(json.dumps({"ms": out["ms"]}), flush=True)
    if not all(out["equal"].values()):
        raise AssertionError("an fsm_decode build disagrees with the plain "
                             "version")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(Path(argv[argv.index("--against") + 1])
         if "--against" in argv else None)
