"""Pin the JAX package's per-chunk total_bits of the min-cost-DP tiers.

Writes ``libdeflate_tpu_torch/experiments/dp_total_bits.json``: for each
DP configuration, the total_bits of every chunk of the 16 MiB corpus of
``libdeflate_tpu_torch/experiments/corpus.py`` in 1 MiB chunks (each
chunk a final block), from the XLA path of
``libdeflate_tpu/compress/tpu_optimal.py``:

- ``optfast``: ``compress_chunk_optimal`` with the keywords of
  ``compress_chunks_optfast_pallas`` (at 1 MiB chunks the Pallas twin
  gives the same bits: one chunk fills its 1024-lane blocks);
- ``optimal``, ``optimal2``, ``deep``: ``compress_chunks_optimal``,
  ``compress_chunks_optimal2``, ``compress_chunks_optimal_deep``;
- ``level5``, ``level8``, ``level10``: the mesh ladder's chunk
  compressor at levels 5-7, 8-9 and 10-12
  (``parallel/mesh.py::_chunk_compressor``).

``chip_smoke.py`` holds the port's output on the card to these numbers
without importing JAX.  One chunk a call (B = 1): total_bits does not
depend on the batch, and a 1 MiB call stays within a few GiB of host
memory.  The seconds each configuration took are written beside its
bits.

Run from the repository root on the CPU (configuration names as
arguments re-pin only those):

    JAX_PLATFORMS=cpu python tests/pin_dp_total_bits.py [optfast ...]
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libdeflate_tpu.compress import tpu_optimal as to  # noqa: E402
from libdeflate_tpu.parallel import mesh  # noqa: E402
from libdeflate_tpu_torch.experiments import corpus as pc  # noqa: E402

OUT = REPO / "libdeflate_tpu_torch" / "experiments" / "dp_total_bits.json"
COMMAND = "JAX_PLATFORMS=cpu python tests/pin_dp_total_bits.py"
OPTFAST = dict(passes=2, use_content=False, use_wide=False,
               ladder=to.LEN_LADDER_DENSE2, ext_c=False, strides2=())
# configuration -> batched XLA function
CONFIGS = {
    "optfast": jax.jit(jax.vmap(lambda b, l, f: to.compress_chunk_optimal(
        b, l, f, match_bias16=jnp.asarray(to._SHORT_BIAS16), **OPTFAST))),
    "optimal": to.compress_chunks_optimal,
    "optimal2": to.compress_chunks_optimal2,
    "deep": to.compress_chunks_optimal_deep,
    "level5": jax.jit(jax.vmap(mesh._chunk_compressor(5))),
    "level8": jax.jit(jax.vmap(mesh._chunk_compressor(8))),
    "level10": jax.jit(jax.vmap(mesh._chunk_compressor(10))),
}


def main() -> int:
    only = set(sys.argv[1:])
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    chunks = np.frombuffer(corpus, np.uint8).reshape(-1, pc.CHUNK)
    length = jnp.array([pc.CHUNK], jnp.int32)
    bfinal = jnp.array([True])
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    bits_all = old.get("total_bits", {})
    secs = old.get("seconds", {})
    for name, fn in CONFIGS.items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        bits = []
        for chunk in chunks:
            _, total = fn(jnp.asarray(chunk[None]), length, bfinal)
            bits.append(int(np.asarray(total)[0]))
        bits_all[name] = bits
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {len(bits)} chunks, {sum(bits) // 8} bytes, "
              f"{secs[name]} s", flush=True)
        OUT.write_text(json.dumps({
            "command": COMMAND,
            "corpus": f"experiments/corpus.py make_corpus({pc.CORPUS_BYTES})",
            "chunk": pc.CHUNK,
            "seconds": secs,
            "total_bits": bits_all}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
