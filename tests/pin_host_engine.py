"""Pin the JAX package's host-engine answers for the port's chip check.

Writes ``libdeflate_tpu_torch/experiments/host_engine_pins.json``: the
length and SHA-256 of ``libdeflate_tpu.Compressor`` output on the
benchmark corpus (``experiments/corpus.py::make_corpus``, 16 MiB) --
native raw DEFLATE of the whole corpus at levels 0-12, the three formats
of its first 1 MiB at levels -1 to 12, the forced Python path on its
first 256 KiB at levels 0-9 and first 16 KiB at levels 10-12 -- and the
``libdeflate_tpu.Decompressor`` 4-tuples of the seeded damaged set on
both backends (``experiments/host_contract.py``).  ``chip_smoke.py``
holds the port to these on the card machine's CPU, where there is no JAX.

    JAX_PLATFORMS=cpu python tests/pin_host_engine.py
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import libdeflate_tpu as ld  # noqa: E402
from libdeflate_tpu import native_backend as jnb  # noqa: E402
from libdeflate_tpu_torch.experiments import host_contract as hc  # noqa: E402
from libdeflate_tpu_torch.experiments.corpus import make_corpus  # noqa: E402


def _entry(out: bytes) -> dict:
    return {"bytes": len(out), "sha256": hc.digest(out)}


def native_pins(corpus: bytes) -> dict:
    """Raw DEFLATE of the corpus at RAW_LEVELS, and the three formats of
    its first FORMAT_SPAN bytes at LEVELS, on the native codec."""
    head = corpus[:hc.FORMAT_SPAN]
    with hc.on_backend("native", jnb):
        return {
            "raw": {str(lv): _entry(ld.Compressor(lv).deflate_compress(
                corpus)) for lv in hc.RAW_LEVELS},
            "formats": {fmt: {str(lv): _entry(ld.Compressor(lv).compress(
                head, fmt)) for lv in hc.LEVELS} for fmt in hc.FORMATS},
        }


def python_pins(corpus: bytes) -> dict:
    """Raw DEFLATE of the first PY_SPAN bytes at PY_LEVELS and of the first
    PY_OPT_SPAN bytes at PY_OPT_LEVELS, on the forced Python path."""
    with hc.on_backend("python", jnb):
        return {str(lv): _entry(ld.Compressor(lv).deflate_compress(
            corpus[:hc.PY_SPAN if lv in hc.PY_LEVELS else hc.PY_OPT_SPAN]))
            for lv in hc.PY_LEVELS + hc.PY_OPT_LEVELS}


def main() -> None:
    corpus = make_corpus()
    secs = {}
    t0 = time.perf_counter()
    native = native_pins(corpus)
    secs["native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = python_pins(corpus)
    secs["python"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hc.on_backend("native", jnb):
        cases = hc.damaged_set(ld, corpus)
    damaged = {}
    for backend in ("native", "python"):
        with hc.on_backend(backend, jnb):
            damaged[backend] = hc.decode_tuples(ld, cases)
    secs["damaged"] = time.perf_counter() - t0
    pins = {"native": native, "python": python, "damaged": damaged,
            "damaged_cases": len(cases), "seconds": secs}
    hc.PINS.write_text(json.dumps(pins, indent=1) + "\n")
    print(json.dumps(secs))


if __name__ == "__main__":
    main()
