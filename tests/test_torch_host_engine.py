"""The port's ``Compressor`` against the JAX package's, on both backends.

``libdeflate_tpu_torch.Compressor(level)`` must give the bytes
``libdeflate_tpu.Compressor(level)`` gives, in all three formats, at every
level -1 to 12, once with both packages on their native codec
(``native/ldtpu_native.cpp``; the port's build lives in ``build/native/``)
and once with both forced onto the Python path
(``experiments/host_contract.forced_python``).  The two backends give
different bytes, so each is held to the JAX package on the same backend.
Inputs come from the benchmark corpus and from numpy seeds: empty, one
byte, the stored-passthrough edge ``55 - 4 * level`` and one either side,
text, random bytes, runs, skewed bytes and records (the larger inputs are
``tests/test_torch_host_engine_large.py``).  The Python near-optimal path
(levels 10-12) costs ~0.15 s a KiB of text on an x86-64 CPU, so its
inputs stay at 2 KiB or less.  Tolerance: exact.
"""

import json

import numpy as np
import pytest

import libdeflate_tpu as ld
import libdeflate_tpu_torch as lt
from libdeflate_tpu import native_backend as jnb
from libdeflate_tpu.compress import engine as jengine
from libdeflate_tpu_torch import native_backend as nb
from libdeflate_tpu_torch.compress import engine
from libdeflate_tpu_torch.experiments import host_contract as hc
from libdeflate_tpu_torch.experiments.corpus import make_corpus

CORPUS = make_corpus(2 << 20)
U = len(CORPUS) // 8
TEXT, SKEW, RECS, RAND, RUNS = (CORPUS[:2 * U], CORPUS[2 * U:4 * U],
                                CORPUS[4 * U:6 * U], CORPUS[6 * U:7 * U],
                                CORPUS[7 * U:])
BACKENDS = ("native", "python")


def on(backend: str):
    """Both packages on ``backend`` for the block."""
    return hc.on_backend(backend, nb, jnb)


def _inputs(backend: str, level: int) -> dict[str, bytes]:
    edge = 55 - 4 * engine.normalize_level(level)
    cases = {"empty": b"", "one byte": b"\x9c"}
    for d in (-1, 0, 1):
        if edge + d >= 0:
            cases[f"passthrough edge {d:+d}"] = TEXT[1000:1000 + edge + d]
    small = backend == "python" and level >= 10
    size = 1024 if small else 4096
    cases["text"] = TEXT[5000:5000 + (2 * size if small else
                                      8192 if backend == "python" else 12288)]
    cases["random"] = RAND[:size]
    # runs cost the Python near-optimal parse the most: ~5 s a KiB at 12
    run = 256 if small else size
    cases["runs"] = RUNS[U // 2 - run // 2:U // 2 + run // 2]
    cases["skew and records"] = SKEW[-size // 2:] + RECS[:size // 2]
    return cases


def _params():
    out = []
    for backend in BACKENDS:
        for level in hc.LEVELS:
            for name in _inputs(backend, level):
                out.append(pytest.param(backend, level, name,
                                        id=f"{backend}-{level}-{name}"))
    return out


@pytest.mark.parametrize("backend,level,name", _params())
def test_compressor_equal(backend, level, name):
    data = _inputs(backend, level)[name]
    with on(backend):
        mine, theirs = lt.Compressor(level), ld.Compressor(level)
        assert mine.get_compression_level() == theirs.get_compression_level()
        for fmt in hc.FORMATS:
            assert mine.compress(data, fmt) == theirs.compress(data, fmt), fmt


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fmt", hc.FORMATS)
def test_out_nbytes_avail_too_small_is_empty(backend, fmt):
    data = TEXT[:3000]
    with on(backend):
        c, jc = lt.Compressor(6), ld.Compressor(6)
        full = getattr(c, f"{fmt}_compress")(data)
        for avail in (0, 1, 18, len(full) - 1, len(full), len(full) + 5):
            got = getattr(c, f"{fmt}_compress")(data, avail)
            assert got == getattr(jc, f"{fmt}_compress")(data, avail)
            assert got == (full if avail >= len(full) else b"")
        bound = getattr(lt, f"{fmt}_compress_bound")(len(data))
        assert bound == getattr(c, f"{fmt}_compress_bound")(len(data)) == \
            getattr(ld, f"{fmt}_compress_bound")(len(data))


@pytest.mark.parametrize("level", [-2, 13, 100])
def test_invalid_levels_raise(level):
    with pytest.raises(ValueError):
        ld.Compressor(level)
    with pytest.raises(ValueError):
        lt.Compressor(level)


def test_level_rules_equal():
    for level in range(-3, 15):
        assert engine.normalize_level(level) == jengine.normalize_level(level)
        if engine.normalize_level(level) is not None:
            assert engine.max_passthrough_size(level) == \
                jengine.max_passthrough_size(level)
    assert lt.Compressor().get_compression_level() == 6
    assert lt.Compressor(-1).get_compression_level() == 6


@pytest.mark.parametrize("seed", range(3))
def test_block_split_equal(seed):
    rng = np.random.default_rng(seed)
    n = 40000
    kinds = (rng.random(n) < (0.1 + 0.3 * (np.arange(n) > n // 2))
             ).astype(np.uint8)
    vals = np.where(kinds == 1, rng.integers(3, 40, n),
                    rng.integers(0, 256, n) >> (np.arange(n) % 3)
                    ).astype(np.int32)
    for soft_max in (300000, 20000):
        assert list(engine._split_items_by_stats(kinds, vals, soft_max)) == \
            list(jengine._split_items_by_stats(kinds, vals, soft_max))


@pytest.mark.parametrize("level", [1, 6])
def test_native_output_equals_the_pins(level):
    # the cheap subset of host_engine_pins.json, which chip_smoke.py holds
    # in full on the card machine's CPU
    pins = json.loads(hc.PINS.read_text())["native"]["formats"]
    head = make_corpus()[:hc.FORMAT_SPAN]
    with on("native"):
        for fmt in hc.FORMATS:
            out = lt.Compressor(level).compress(head, fmt)
            assert {"bytes": len(out), "sha256": hc.digest(out)} == \
                pins[fmt][str(level)], fmt
