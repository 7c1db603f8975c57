"""Pin the JAX package's per-chunk total_bits of the compress options
that only ``scripts/`` reaches.

Writes ``libdeflate_tpu_torch/experiments/option_total_bits.json``: for
each configuration below, the total_bits of every 1 MiB chunk of the
16 MiB corpus of ``libdeflate_tpu_torch/experiments/corpus.py`` (the
chunks not final, as ``scripts/tier_matrix.py`` calls them; total_bits
does not depend on BFINAL), with the seconds each configuration took.

- Through the XLA path of ``libdeflate_tpu/compress/tpu_optimal.py``
  (``compress_chunk_optimal``; at 1 MiB chunks it gives the bits of
  ``_compress_chunks_optimal_pallas`` with the same keywords, as
  ``tests/pin_dp_total_bits.py`` says): ``leanD(C+dense)`` (the
  ``LEN_LADDER_DENSE`` ladder), ``lean1XR(p1,rawC,rowlit)``,
  ``lean1X8(p1,rawC,lcp8)``, ``lean1XR8(rawC,rowlit,lcp8)``,
  ``scripts/ratio_ab.py``'s ``rowlit+lcp12`` and the deep tier with
  ``content_round_probes``.
- ``dyn-lcp8-d4`` through ``compress_chunk_dynamic(lcp=8, depth=4)``.
- ``leanI(D+flatlit1)``, ``lean``, and lean and ``leanD`` with
  ``emit_blocks=4`` have no XLA twin: ``_compress_chunks_optimal_pallas``
  in interpret mode (``compress_chunks_lean_pallas`` for ``lean``).
  ``lean`` is also the pin of lean with ``pm_group=64``, which changes how
  the words are put together, not the words.

``--chunks N`` pins only the first N chunks; the JSON's ``chunks`` says
how many each configuration holds (all 16 took 26-275 s a configuration
on the CPU, by the JSON's ``seconds``).

One chunk a call (B = 1), which keeps a call within a few GiB of host
memory.  Run from the repository root on the CPU (configuration names as
arguments re-pin only those):

    JAX_PLATFORMS=cpu python tests/pin_option_total_bits.py [name ...]
"""

from __future__ import annotations

import functools
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
from libdeflate_tpu_torch.experiments import corpus as pc  # noqa: E402

OUT = REPO / "libdeflate_tpu_torch" / "experiments" / "option_total_bits.json"
COMMAND = "JAX_PLATFORMS=cpu python tests/pin_option_total_bits.py"

# scripts/tier_matrix.py's keywords
P1 = dict(depth=6, two_pass=False, hash3=False, passes=1,
          use_content=False, use_wide=False, ladder=to.LEN_LADDER_DENSE2,
          ext_c=False)
LEAN_D = dict(depth=6, two_pass=False, hash3=False, passes=2,
              use_content=False, use_wide=False, ladder=to.LEN_LADDER_DENSE)
LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=to.LEN_LADDER_DENSE2,
            ext_c=False, strides2=(), refine=0, lit_sample=32)
DEEP = dict(depth=12, two_pass=True, hash3=True, passes=3,
            content_doublings=2, ladder=to.LEN_LADDER_DENSE2,
            match_bias16=to._SHORT_BIAS16)


def _xla(**kw):
    """compress_chunk_optimal with keywords, batched."""
    return jax.jit(jax.vmap(lambda b, l, f: to.compress_chunk_optimal(
        b, l, f, **{k: jnp.asarray(v) if k == "match_bias16" else v
                    for k, v in kw.items()})))


def _pallas(**kw):
    return jax.jit(functools.partial(to._compress_chunks_optimal_pallas,
                                     interpret=True, **kw))


# configuration -> batched JAX function
CONFIGS = {
    "leanD(C+dense)": _xla(**LEAN_D),
    "lean1XR(p1,rawC,rowlit)": _xla(**P1, row_lit1=True),
    "lean1X8(p1,rawC,lcp8)": _xla(**P1, lcp=8),
    "lean1XR8(rawC,rowlit,lcp8)": _xla(**P1, row_lit1=True, lcp=8),
    "rowlit+lcp12": _xla(**P1, row_lit1=True, lcp=12),
    "deep+round_probes": _xla(**DEEP, content_round_probes=True),
    "dyn-lcp8-d4": jax.jit(jax.vmap(functools.partial(
        td.compress_chunk_dynamic, lcp=8, depth=4))),
    "leanI(D+flatlit1)": _pallas(**LEAN_D, flat_lit1=True),
    "lean": functools.partial(to.compress_chunks_lean_pallas,
                              interpret=True),
    "lean+emit_blocks4": _pallas(**LEAN, emit_blocks=4),
    "leanD+emit_blocks4": _pallas(**LEAN_D, emit_blocks=4),
}


def main() -> int:
    args = sys.argv[1:]
    limit = None
    if "--chunks" in args:
        i = args.index("--chunks")
        limit = int(args[i + 1])
        del args[i:i + 2]
    only = set(args)
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    chunks = np.frombuffer(corpus, np.uint8).reshape(-1, pc.CHUNK)
    length = jnp.array([pc.CHUNK], jnp.int32)
    bfinal = jnp.array([False])
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    bits_all = old.get("total_bits", {})
    secs = old.get("seconds", {})
    for name, fn in CONFIGS.items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        bits = []
        for chunk in chunks[:limit]:
            _, total = fn(jnp.asarray(chunk[None]), length, bfinal)
            bits.append(int(np.asarray(total)[0]))
            print(f"  {name} chunk {len(bits) - 1}: {bits[-1]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        bits_all[name] = bits
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {len(bits)} chunks, {sum(bits) // 8} bytes, "
              f"{secs[name]} s", flush=True)
        OUT.write_text(json.dumps({
            "command": COMMAND,
            "corpus": f"experiments/corpus.py make_corpus({pc.CORPUS_BYTES})",
            "chunk": pc.CHUNK,
            "bfinal": False,
            "chunks": {k: len(v) for k, v in bits_all.items()},
            "seconds": secs,
            "total_bits": bits_all}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
