"""Pin the JAX package's per-chunk total_bits and SHA-256 on the soak's
random-length payloads.

Writes ``libdeflate_tpu_torch/experiments/soak_pins.json``: the payloads
of ``chip_smoke.py``'s soak phase, drawn by ``scripts/tpu_soak.py``'s own
``gen_payload`` and generator (seed 0xF00D, B = 4 chunks of up to 1 MiB
a batch, two batches a tier, the nine tiers taken in turn, BFINAL on the
even chunks), and for every chunk the total_bits and the SHA-256 of the
bytes (``device_stream_to_bytes``) that the JAX package gives:

- ``static``, ``dyn1``, ``dyn2``, ``dyn3``: the XLA entries of
  ``tpu_pipeline.py`` and ``tpu_dynamic.py``;
- ``optfast``: ``compress_chunk_optimal`` with the keywords of
  ``compress_chunks_optfast_pallas``, as ``tests/pin_dp_total_bits.py``
  pins it; ``optimal``, ``optimal2``, ``deep``: the XLA entries of
  ``tpu_optimal.py``;
- ``lean``: ``compress_chunks_lean_pallas`` in interpret mode.

The JSON also holds the recipe, each chunk's length and the SHA-256 of
each payload, which ``tests/test_torch_soak.py`` holds to the port's
draws and to ``chip_smoke.py``'s constants, and the seconds each tier
took.  One chunk a call (B = 1), which keeps a call within a few GiB of
host memory.  Run from the repository root on the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/pin_soak.py
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libdeflate_tpu.compress import tpu_dynamic as td  # noqa: E402
from libdeflate_tpu.compress import tpu_optimal as to  # noqa: E402
from libdeflate_tpu.compress import tpu_pipeline as tp  # noqa: E402
from libdeflate_tpu_torch.experiments import soak  # noqa: E402

COMMAND = "JAX_PLATFORMS=cpu python tests/pin_soak.py"
BATCHES_A_TIER = 2
OPTFAST = dict(passes=2, use_content=False, use_wide=False,
               ladder=to.LEN_LADDER_DENSE2, ext_c=False, strides2=())
JAX = {
    "static": tp.compress_chunks_static,
    "dyn1": td.compress_chunks_dynamic,
    "dyn2": td.compress_chunks_dynamic2,
    "dyn3": td.compress_chunks_dynamic3,
    "lean": functools.partial(to.compress_chunks_lean_pallas,
                              interpret=True),
    "optfast": jax.jit(jax.vmap(lambda b, l, f: to.compress_chunk_optimal(
        b, l, f, match_bias16=jnp.asarray(to._SHORT_BIAS16), **OPTFAST))),
    "optimal": to.compress_chunks_optimal,
    "optimal2": to.compress_chunks_optimal2,
    "deep": to.compress_chunks_optimal_deep,
}


def script_payloads(batches: int, seed: int, b: int = soak.B,
                    n: int = soak.N):
    """The payloads of ``scripts/tpu_soak.py`` (its ``gen_payload`` and
    its draw of lengths, lines 66-73)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_soak", REPO / "scripts" / "tpu_soak.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rng = np.random.default_rng(seed)
    for batch in range(batches):
        payloads = []
        for k in range(b):
            ln = int(rng.integers(1, n + 1)) if rng.random() < 0.5 else n
            payloads.append(script.gen_payload(rng, (batch * b + k) % 5, ln))
        yield payloads


def main() -> int:
    tiers = tuple(soak.TIERS)
    batches = BATCHES_A_TIER * len(tiers)
    rec = soak.recipe(batches, soak.SEED, tiers)
    out = {"command": COMMAND, "recipe": rec, "lengths": [],
           "payload_sha256": [], "total_bits": [], "sha256": [],
           "seconds": {t: 0.0 for t in tiers}}
    for batch, payloads in enumerate(script_payloads(batches, soak.SEED)):
        tier = tiers[batch % len(tiers)]
        bufs, lens, bfinal = soak.batch_arrays(payloads)
        bits, digests = [], []
        t0 = time.perf_counter()
        for i in range(soak.B):
            w, t = JAX[tier](jnp.asarray(bufs[i:i + 1]),
                             jnp.asarray(lens[i:i + 1], jnp.int32),
                             jnp.asarray(bfinal[i:i + 1]))
            total = int(np.asarray(t)[0])
            s = tp.device_stream_to_bytes(np.asarray(w)[0], total)
            bits.append(total)
            digests.append(hashlib.sha256(s).hexdigest())
        out["seconds"][tier] = round(out["seconds"][tier]
                                     + time.perf_counter() - t0, 1)
        out["lengths"].append(lens.tolist())
        out["payload_sha256"].append([hashlib.sha256(p).hexdigest()
                                      for p in payloads])
        out["total_bits"].append(bits)
        out["sha256"].append(digests)
        print(f"batch {batch} {tier}: lengths {lens.tolist()}, total_bits "
              f"{bits}, {out['seconds'][tier]} s", flush=True)
    soak.PINS.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
