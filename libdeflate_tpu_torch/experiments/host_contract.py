"""The host contract's pinned cases: inputs, the damaged set and the pins.

``Compressor`` and ``Decompressor`` run on the host engine: the native C++
codec when it loads, else the numpy/Python path.  The two give different
bytes, so every case is taken on each backend.  The functions here take the
package (``libdeflate_tpu_torch``, or another with the same contract and a
``native_backend`` module) as an argument, so that ``tests/pin_host_engine.py``
pins the JAX package's answers on one host and ``chip_smoke.py`` holds the
port to them on another, with no JAX there.

- ``forced_python``: the Python path, forced by marking each package's
  native library as tried and absent for the duration (the environment
  knob ``LIBDEFLATE_TPU_NO_NATIVE`` is read only at the first load);
  ``on_backend`` takes either backend by name;
- ``damaged_set``: seeded bit flips, byte overwrites and truncations of
  ``Compressor`` output in the three formats, with output sizes one short
  and one long of the original;
- ``decode_tuples``: the ``Decompressor`` 4-tuples of a set of cases, with
  the output as its SHA-256;
- the spans and levels of ``host_engine_pins.json``: the raw DEFLATE of
  the benchmark corpus (``experiments/corpus.py``) at RAW_LEVELS and the
  three formats of its first FORMAT_SPAN bytes at LEVELS, native; its
  first PY_SPAN bytes at PY_LEVELS and PY_OPT_SPAN at PY_OPT_LEVELS on the
  Python path.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np

from .corpus import REPO

PINS = REPO / "libdeflate_tpu_torch" / "experiments" / "host_engine_pins.json"
LEVELS = tuple(range(-1, 13))
FORMATS = ("deflate", "zlib", "gzip")
RAW_LEVELS = tuple(range(0, 13))     # native raw DEFLATE of the whole corpus
FORMAT_SPAN = 1 << 20                # native, three formats, levels -1..12
PY_SPAN = 256 << 10                  # Python path, levels 0..9
PY_OPT_SPAN = 16 << 10               # Python path, levels 10..12
PY_LEVELS = tuple(range(0, 10))
PY_OPT_LEVELS = (10, 11, 12)
DAMAGE_SEED = 0xDA3A6E
DAMAGE_SPAN = 8 << 10
DAMAGE_LEVELS = (1, 6, 12)


@contextlib.contextmanager
def forced_python(*backends):
    """Within the block each ``native_backend`` module reports no native
    library, so ``Compressor``, ``Decompressor`` and the checksums take
    the Python path; the modules' state is restored afterwards."""
    saved = [(b, b._lib, b._tried) for b in backends]
    for b in backends:
        b._lib, b._tried = None, True
    try:
        yield
    finally:
        for b, lib, tried in saved:
            b._lib, b._tried = lib, tried


@contextlib.contextmanager
def on_backend(name: str, *backends):
    """Each ``native_backend`` module on ``name`` ("native" or "python")
    for the block; "native" raises unless every native library loaded, so
    that a failed build cannot pass as the native codec."""
    if name == "python":
        with forced_python(*backends):
            yield
        return
    if name != "native" or not all(b.available() for b in backends):
        raise RuntimeError(f"backend {name!r} is not available")
    yield


def digest(data: bytes | None) -> str | None:
    return None if data is None else hashlib.sha256(data).hexdigest()


def damage_sources(corpus: bytes) -> list[bytes]:
    """Six DAMAGE_SPAN slices of the corpus, one in each of its parts (text,
    skewed bytes, records, random, runs) and one across the text/skew
    border, at seeded offsets, plus a 100-byte one."""
    rng = np.random.default_rng(DAMAGE_SEED)
    u = len(corpus) // 8
    starts = [int(rng.integers(lo, hi - DAMAGE_SPAN)) for lo, hi in (
        (0, 2 * u), (2 * u, 4 * u), (4 * u, 6 * u), (6 * u, 7 * u),
        (7 * u, 8 * u))]
    starts.append(2 * u - DAMAGE_SPAN // 2)
    out = [corpus[s:s + DAMAGE_SPAN] for s in starts]
    return out + [corpus[starts[0]:starts[0] + 100]]


def damaged_set(pkg, corpus: bytes) -> list[tuple[str, bytes, int]]:
    """(format, stream, out_nbytes_avail) cases: each source compressed by
    ``pkg.Compressor`` in each format (levels DAMAGE_LEVELS in turn), then
    left whole, whole with one byte too few or too many of output room,
    1-3 bit flips, a byte overwritten, cut in the middle, cut by 1-3 bytes
    at the end, and followed by 4 trailing bytes."""
    rng = np.random.default_rng(DAMAGE_SEED + 1)
    cases = []
    for i, src in enumerate(damage_sources(corpus)):
        for j, fmt in enumerate(FORMATS):
            level = DAMAGE_LEVELS[(i + j) % len(DAMAGE_LEVELS)]
            s = pkg.Compressor(level).compress(src, fmt)
            n = len(src)
            cases += [(fmt, s, n), (fmt, s, n - 1), (fmt, s, n + 1)]
            b = bytearray(s)
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(0, 8 * len(b)))
                b[k // 8] ^= 1 << (k % 8)
            cases.append((fmt, bytes(b), n))
            b = bytearray(s)
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            cases.append((fmt, bytes(b), n))
            cases.append((fmt, s[:int(rng.integers(1, len(s)))], n))
            cases.append((fmt, s[:len(s) - int(rng.integers(1, 4))], n))
            cases.append((fmt, s + rng.integers(0, 256, 4, np.uint8)
                          .tobytes(), n))
    return cases


def decode_tuples(pkg, cases) -> list[list]:
    """[result, SHA-256 of the output or None, actual_in, actual_out] of
    ``pkg.Decompressor`` on each case, known size then unknown size."""
    d = pkg.Decompressor()
    rows = []
    for fmt, stream, avail in cases:
        for known in (True, False):
            res, out, ain, aout = d.decompress(stream, avail, fmt, known)
            rows.append([res, digest(out), ain, aout])
    return rows
