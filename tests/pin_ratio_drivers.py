"""Pin the JAX package's bits on the configurations of the ported
measurement and ratio drivers.

Writes ``libdeflate_tpu_torch/experiments/ratio_total_bits.json``, which
``chip_smoke.py``'s ``drivers_phase`` holds the card to:

- ``ablations``: each of ``scripts/ablate_lean.py``'s eight ablations
  (its own ``lean_pipeline``, taken from its source by ``ast``, the
  kernels in interpret mode) on the first four 1 MiB chunks of the corpus
  of ``experiments/corpus.py``, not final: per chunk the total_bits and
  the SHA-256 of the bytes (``device_stream_to_bytes``);
- ``configs``: every configuration of the port's ``ratio_ab``,
  ``exp_corpus2_breadth``, ``exp_match_bias`` (the nine bias shapes, one
  compile), ``exp_r5_speed``, ``exp_dp_corpus`` and ``exp_ratio_gap``
  drivers, as the scripts run them (``tests/driver_cases.py``), on the
  first 1 MiB chunk of that corpus ("corpus1") and of
  ``corpus.make_corpus2``'s text part ("c2-text"): total_bits and
  SHA-256;
- ``ratio_gap_recost``: ``scripts/exp_ratio_gap.py``'s re-costing of the
  L6 parse of those two chunks (bits under the device's code lengths and
  package-merge at 11 and 15).

One chunk a JAX call (B = 1), which keeps a call within a few GiB of host
memory.  Run from the repository root on the CPU (names as arguments
re-pin only the configurations or ablations whose names contain one of
them):

    JAX_PLATFORMS=cpu python tests/pin_ratio_drivers.py [name ...]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import driver_cases as dc  # noqa: E402
from libdeflate_tpu.compress.tpu_pipeline import (  # noqa: E402
    device_stream_to_bytes)
from libdeflate_tpu_torch.experiments import corpus as pc  # noqa: E402

OUT = REPO / "libdeflate_tpu_torch" / "experiments" / "ratio_total_bits.json"
COMMAND = "JAX_PLATFORMS=cpu python tests/pin_ratio_drivers.py"
ABLATION_CHUNKS = 4


def chunk_sets() -> dict:
    return {"corpus1": pc.make_corpus(pc.CORPUS_BYTES)[: pc.CHUNK],
            "c2-text": pc.make_corpus2(pc.CORPUS_BYTES)[: pc.CHUNK]}


def pin(fn, chunk: bytes) -> list:
    """[total_bits, SHA-256] of one chunk, not final, through fn."""
    w, t = fn(jnp.asarray(np.frombuffer(chunk, np.uint8)[None]),
              jnp.array([len(chunk)], jnp.int32), jnp.array([False]))
    total = int(np.asarray(t)[0])
    stream = device_stream_to_bytes(np.asarray(w)[0], total)
    return [total, hashlib.sha256(stream).hexdigest()]


def main() -> int:
    only = sys.argv[1:]
    sets = chunk_sets()
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    ablations = old.get("ablations", {})
    configs = old.get("configs", {})
    secs = old.get("seconds", {})

    def wanted(name):
        return not only or any(o in name for o in only)

    def save():
        OUT.write_text(json.dumps({
            "command": COMMAND,
            "chunks": {"corpus1": "make_corpus(16777216)[:1048576]",
                       "c2-text": "make_corpus2(16777216)[:1048576]",
                       "ablations": f"the first {ABLATION_CHUNKS} chunks of "
                                    f"make_corpus(16777216)"},
            "bfinal": False,
            "seconds": secs,
            "ablations": ablations,
            "configs": configs,
            "ratio_gap_recost": recost}, indent=1) + "\n")

    recost = old.get("ratio_gap_recost", {})
    if wanted("recost"):
        t0 = time.perf_counter()
        recost = {tag: dc.ratio_gap_recost(
            jnp.asarray(np.frombuffer(ch, np.uint8)[None]),
            jnp.array([len(ch)], jnp.int32)) for tag, ch in sets.items()}
        secs["ratio_gap_recost"] = round(time.perf_counter() - t0, 1)
        print(f"recost: {recost}", flush=True)
        save()
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    for name in dc.ABLATE["ABLATIONS"]:
        if not wanted(name):
            continue
        ab = () if name == "none" else (name,)
        fn = jax.jit(lambda b, l, f, _ab=ab: dc.ABLATE["lean_pipeline"](
            b, l, f, _ab))
        t0 = time.perf_counter()
        ablations[name] = [pin(fn, corpus[k * pc.CHUNK:(k + 1) * pc.CHUNK])
                           for k in range(ABLATION_CHUNKS)]
        secs[f"ablate_lean/{name}"] = round(time.perf_counter() - t0, 1)
        print(f"ablate_lean/{name}: {ablations[name]} "
              f"({secs[f'ablate_lean/{name}']} s)", flush=True)
        save()
    for name, fn in dc.jax_configs().items():
        if not wanted(name):
            continue
        t0 = time.perf_counter()
        configs[name] = {tag: pin(fn, ch) for tag, ch in sets.items()}
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {configs[name]} ({secs[name]} s)", flush=True)
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
