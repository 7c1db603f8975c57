"""The benchmark corpus and the per-class zlib-6 streams of the measurements.

``make_corpus`` is the recipe of the JAX package's ``bench.make_corpus``
(seed 0x51E51A: text, skewed-alphabet markov bytes, 64-byte records with 5%
noise, random bytes, runs), with this repository's own ``SURVEY.md`` and
``PERF_NOTES.md`` as the text part, found from the package's path.
``class_streams`` is ``scripts/exp_tokenize_ceiling.py::class_streams``
(lines 396-413): one class of that corpus cut into chunks and compressed
by zlib level 6 as raw DEFLATE.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SEED = 0x51E51A
CHUNK = 1 << 20
CORPUS_BYTES = 16 << 20
CLASSES = ("text", "skew", "recs", "rand", "runs", "mixed")


def make_corpus(total: int = CORPUS_BYTES, root: Path = REPO) -> bytes:
    """``total`` bytes (a multiple of 8) of the benchmark corpus."""
    rng = np.random.default_rng(SEED)
    txt = b"".join((root / name).read_bytes()
                   for name in ("SURVEY.md", "PERF_NOTES.md"))
    unit = total // 8
    parts = [
        (txt * (2 * unit // len(txt) + 1))[: 2 * unit],
        rng.choice(
            np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz .,\n'-", np.uint8),
            size=2 * unit, p=rng.dirichlet(np.ones(32) * 0.2)).tobytes(),
    ]
    rec = rng.integers(0, 256, size=64, dtype=np.uint8)
    recs = np.tile(rec, 2 * unit // 64)
    noise = rng.integers(0, 256, size=recs.size, dtype=np.uint8)
    recs = np.where(rng.random(recs.size) < 0.05, noise, recs).astype(np.uint8)
    parts.append(recs.tobytes())
    parts.append(rng.integers(0, 256, size=unit, dtype=np.uint8).tobytes())
    parts.append(b"\x00" * (unit // 2) + b"abcdefgh" * (unit // 16))
    return b"".join(parts)[:total]


def zlib_raw(data: bytes, level: int = 6,
             strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """Raw DEFLATE of data by zlib, at the scripts' settings
    (``compressobj(level, DEFLATED, -15)``: memLevel 8)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(data) + c.flush()


def class_streams(cls: str, total: int = CORPUS_BYTES, chunk: int = CHUNK,
                  corpus: bytes | None = None):
    """(chunks, streams) of one class: the corpus span text 0-2u, skew
    2u-4u, recs 4u-6u, rand 6u-7u, runs 7u-8u or mixed (all), u = total / 8,
    cut into ``chunk``-byte chunks, each compressed by zlib level 6."""
    corpus = make_corpus(total) if corpus is None else corpus
    u = len(corpus) // 8
    spans = {"text": (0, 2 * u), "skew": (2 * u, 4 * u),
             "recs": (4 * u, 6 * u), "rand": (6 * u, 7 * u),
             "runs": (7 * u, 8 * u), "mixed": (0, 8 * u)}
    lo, hi = spans[cls]
    data = corpus[lo:hi]
    nch = max(len(data) // chunk, 1)
    chunks = [data[i * chunk:(i + 1) * chunk] for i in range(nch)]
    return chunks, [zlib_raw(ch) for ch in chunks]
