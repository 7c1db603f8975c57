"""Pin the JAX package's per-chunk total_bits of the greedy/lazy tiers.

Writes ``libdeflate_tpu_torch/experiments/greedy_total_bits.json``: for
each of ``compress_chunks_static`` and ``compress_chunks_dynamic{,2,3}``
(``libdeflate_tpu/compress/tpu_pipeline.py``, ``tpu_dynamic.py``), the
total_bits of every 1 MiB chunk of the 16 MiB corpus of
``libdeflate_tpu_torch/experiments/corpus.py`` (each chunk a final block).
``chip_smoke.py`` holds the port's output on the card to these numbers
without importing JAX.  One chunk a call (B = 1): total_bits does not
depend on the batch, and a 1 MiB call stays within a few GiB of host
memory.

Run from the repository root on the CPU (about ten minutes):

    JAX_PLATFORMS=cpu python tests/pin_greedy_total_bits.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libdeflate_tpu.compress import tpu_dynamic as td  # noqa: E402
from libdeflate_tpu.compress import tpu_pipeline as tp  # noqa: E402
from libdeflate_tpu_torch.experiments import corpus as pc  # noqa: E402

OUT = REPO / "libdeflate_tpu_torch" / "experiments" / "greedy_total_bits.json"
COMMAND = "JAX_PLATFORMS=cpu python tests/pin_greedy_total_bits.py"
TIERS = {"static": tp.compress_chunks_static,
         "dyn1": td.compress_chunks_dynamic,
         "dyn2": td.compress_chunks_dynamic2,
         "dyn3": td.compress_chunks_dynamic3}


def main() -> int:
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    chunks = np.frombuffer(corpus, np.uint8).reshape(-1, pc.CHUNK)
    length = jnp.array([pc.CHUNK], jnp.int32)
    bfinal = jnp.array([True])
    tiers = {}
    for name, fn in TIERS.items():
        t0 = time.perf_counter()
        bits = []
        for chunk in chunks:
            _, total = fn(jnp.asarray(chunk[None]), length, bfinal)
            bits.append(int(np.asarray(total)[0]))
        tiers[name] = bits
        print(f"{name}: {sum(bits) // 8} bytes, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    OUT.write_text(json.dumps({
        "command": COMMAND,
        "corpus": f"experiments/corpus.py make_corpus({pc.CORPUS_BYTES})",
        "chunk": pc.CHUNK,
        "total_bits": tiers}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
