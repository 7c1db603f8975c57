"""The benchmark corpus and the per-class zlib-6 streams of the measurements.

``make_corpus`` is the recipe of the JAX package's ``bench.make_corpus``
(seed 0x51E51A: text, skewed-alphabet markov bytes, 64-byte records with 5%
noise, random bytes, runs), with this repository's own ``SURVEY.md`` and
``PERF_NOTES.md`` as the text part, found from the package's path.
``class_streams`` is ``scripts/exp_tokenize_ceiling.py::class_streams``
(lines 396-413): one class of that corpus cut into chunks and compressed
by zlib level 6 as raw DEFLATE.

``make_corpus2`` is the recipe of ``bench.make_corpus2`` (seed 0xC0FFEE:
source text, base64-ish symbols from a Dirichlet draw, 37-byte records
with 2% noise, runs), with this repository's ``native/ldtpu_native.cpp``
(77 KB of C++) as the text part where bench reads the reference's
``lib/**/*.{c,h}``.  ``corpus1_classes``, ``corpus2_classes`` and
``match_bias_sets`` are the class spans that
``scripts/exp_corpus2_breadth.py`` (lines 34-45) and
``scripts/exp_match_bias.py`` (lines 41-45) cut.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SEED = 0x51E51A
SEED2 = 0xC0FFEE
TEXT2 = "native/ldtpu_native.cpp"
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


def make_corpus2(total: int = CORPUS_BYTES, root: Path = REPO) -> bytes:
    """``total`` bytes of the second corpus: with u = total // 10, source
    text 0-4u, base64 symbols 4u-6u, records 6u-9u, runs 9u-10u."""
    rng = np.random.default_rng(SEED2)
    txt = (root / TEXT2).read_bytes()
    unit = total // 10
    b64 = np.frombuffer(
        b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
        np.uint8)
    rec = rng.integers(0, 256, size=37, dtype=np.uint8)
    recs = np.tile(rec, 3 * unit // 37 + 1)[: 3 * unit]
    noise = rng.integers(0, 256, size=recs.size, dtype=np.uint8)
    recs = np.where(rng.random(recs.size) < 0.02, noise, recs).astype(np.uint8)
    parts = [
        (txt * (4 * unit // len(txt) + 1))[: 4 * unit],
        rng.choice(b64, size=2 * unit,
                   p=rng.dirichlet(np.ones(64) * 0.5)).tobytes(),
        recs.tobytes(),
        b"\xff" * (unit // 2) + b"0123456789abcdef" * (unit // 32),
    ]
    return b"".join(parts)[:total]


def corpus1_classes(total: int = CORPUS_BYTES):
    """[(name, lo, hi)] of ``make_corpus``'s classes."""
    u = total // 8
    return [("text", 0, 2 * u), ("skew", 2 * u, 4 * u),
            ("recs", 4 * u, 6 * u), ("rand", 6 * u, 7 * u),
            ("runs", 7 * u, 8 * u)]


def corpus2_classes(total: int = CORPUS_BYTES):
    """[(name, lo, hi)] of ``make_corpus2``'s classes."""
    u = total // 10
    return [("text", 0, 4 * u), ("b64", 4 * u, 6 * u),
            ("recs", 6 * u, 9 * u), ("runs", 9 * u, 10 * u)]


def match_bias_sets(corp1: bytes, corp2: bytes) -> dict:
    """The three sets of ``scripts/exp_match_bias.py``: the first corpus,
    the second's text and its records."""
    u2 = len(corp2) // 10
    return {"corpus1": corp1, "c2-text": corp2[: 4 * u2],
            "c2-recs": corp2[6 * u2: 9 * u2]}


def chunk_rows(data: bytes, chunk: int = CHUNK) -> np.ndarray:
    """data's whole ``chunk``-byte chunks (at least one), uint8 [n, chunk],
    as the scripts cut a set."""
    nch = max(len(data) // chunk, 1)
    return np.frombuffer(data[: nch * chunk], np.uint8).reshape(nch, chunk)


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
