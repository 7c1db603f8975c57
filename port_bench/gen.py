"""The one traffic generator: files of class pieces made from a seed.

A traffic mix (``traffic/<name>.json``) names a class table
(``data/<classes>.json``), the size of a file, how many distinct files
the window takes in turn, the size of a piece and each class's weight.
A file is cut into pieces; each piece is of one class.  Every seed gets
the same number of pieces of each class (the weights' exact share of
the pieces), in another order and with other bytes, so two seeds ask
the program for the same amount of work.

Reads only this package's files: the frozen text of ``data/``.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed`` (any whole number) for one stream of
    draws; streams are independent."""
    return np.random.default_rng([seed % 2**64, stream])


def load_classes(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def piece_counts(weights: dict, pieces: int) -> dict:
    """Pieces of each class: the weights' share of ``pieces``, rounded by
    largest remainder, ties to the class listed first."""
    total = sum(weights.values())
    exact = {c: pieces * w / total for c, w in weights.items()}
    counts = {c: int(v) for c, v in exact.items()}
    order = sorted(weights, key=lambda c: -(exact[c] - counts[c]))
    for c in order[:pieces - sum(counts.values())]:
        counts[c] += 1
    return counts


class Classes:
    """The class table: makes one piece of a class from a generator."""

    def __init__(self, table: dict):
        self.table = table
        self.text = np.frombuffer(
            (DATA / table["text"]["file"]).read_bytes(), np.uint8)
        skew = table["skew"]
        alpha = np.frombuffer(skew["alphabet"].encode(), np.uint8)
        p = np.random.default_rng(skew["dist_seed"]).dirichlet(
            np.ones(len(alpha)) * skew["dirichlet"])
        # a lookup table of 2^bits entries holds each letter in
        # proportion to its probability, so a draw is one index
        size = 1 << skew["table_bits"]
        counts = np.floor(p * size).astype(np.int64)
        counts[np.argsort(-(p * size - counts))[:size - counts.sum()]] += 1
        self.skew_table = np.repeat(alpha, counts)

    def piece(self, cls: str, n: int, rng: np.random.Generator) -> np.ndarray:
        if cls == "text":
            start = int(rng.integers(len(self.text)))
            reps = -(-(start + n) // len(self.text))
            return np.tile(self.text, reps)[start:start + n]
        if cls == "skew":
            return self.skew_table[rng.integers(0, len(self.skew_table), n)]
        if cls == "recs":
            recs = self.table["recs"]
            rec = rng.integers(0, 256, recs["record_bytes"], dtype=np.uint8)
            out = np.resize(rec, n)
            noisy = rng.integers(0, recs["noise_in"], n, dtype=np.uint8) == 0
            out[noisy] = rng.integers(0, 256, int(noisy.sum()), dtype=np.uint8)
            return out
        if cls == "rand":
            return rng.integers(0, 256, n, dtype=np.uint8)
        if cls == "runs":
            pat = np.frombuffer(self.table["runs"]["pattern"].encode(),
                                np.uint8)
            out = np.zeros(n, np.uint8)
            out[n // 2:] = np.resize(pat, n - n // 2)
            return out
        raise ValueError(f"unknown class {cls!r}")


def make_files(mix: dict, seed: int) -> list[bytes]:
    """The mix's distinct files for ``seed``: each ``file_bytes`` long,
    cut into pieces of ``piece_bytes``, the classes' counts fixed by the
    weights and their order drawn from the seed."""
    classes = Classes(load_classes(mix["classes"]))
    n, piece = mix["file_bytes"], mix["piece_bytes"]
    pieces = -(-n // piece)
    counts = piece_counts(mix["weights"], pieces)
    files = []
    for f in range(mix["files"]):
        rng = rng_of(seed, f)
        kinds = [c for c, k in counts.items() for _ in range(k)]
        rng.shuffle(kinds)
        out = np.empty(pieces * piece, np.uint8)
        for i, cls in enumerate(kinds):
            out[i * piece:(i + 1) * piece] = classes.piece(cls, piece, rng)
        files.append(out[:n].tobytes())
    return files


def raw_deflate(chunk: bytes, level: int) -> bytes:
    """One chunk as an independent raw-DEFLATE stream by zlib."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(chunk) + c.flush()


def chunk_streams(data: bytes, chunk: int, level: int,
                  threads: int | None = None) -> list[bytes]:
    """data's chunks as zlib raw-DEFLATE streams, made in a thread pool
    (zlib releases the interpreter lock)."""
    chunks = [data[i:i + chunk] for i in range(0, len(data), chunk)]
    with ThreadPoolExecutor(threads or min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda c: raw_deflate(c, level), chunks))
