"""Randomized fuzz of the port: the counterpart of ``scripts/fuzz.py``.

Three targets a trial, each drawing from one ``np.random.default_rng(seed)``
in the script's order, so that with ``--device-every 0`` a seed gives the
script's inputs:

- decompress (``fuzz.py:76-109``): garbage, or a zlib stream of
  ``gen_data`` with 1-7 bytes overwritten and its wrapper cut off, through
  the port's ``Decompressor``: a result code of the four, and a success
  only where zlib decodes the stream too, with zlib's bytes; the zlib and
  gzip wrappers on the same bytes end with a code;
- compress (``fuzz.py:112-128``): ``gen_data`` at a random level 0-12 in a
  random format through ``Compressor``, within
  ``deflate_compress_bound + 18``, back through zlib and ``Decompressor``;
- device, every ``--device-every`` trials (``fuzz.py:131-172``): an 8 KiB
  row of ``gen_data`` through the static and dyn1 entries, each stream
  back through zlib; then the row's zlib-6 stream and damaged copies of
  it (one flipped bit, ``fuzz_decompress``'s 1-7 overwritten bytes, a
  cut) go to the decoders, every row of the run in one call a decoder:
  K3 at known size and at unknown size (``decode.decompress_chunks_words``)
  and F1 (``fsm.decompress_chunks``).

The decoders' oracles: on the card each equals its plain version
(``decode.decode_chunks_plain``, ``fsm.decode_chunks_fsm_plain``) in all
four outputs; the clean stream decodes to the row, status 0, every byte
consumed; where a decoder says success on a damaged row and zlib decodes
it too, the bytes equal zlib's prefix.  A success that zlib rejects is
counted and printed, not failed: the reference accepts a stored LEN past
the stream's end while the zero padding covers it
(``ROADMAP.md`` queue 3).  K3 and F1 are not held to each other on damaged
rows, since the two JAX decoders differ there.

Run from the repository root (the device target on the card)::

    python3 -m libdeflate_tpu_torch.experiments.fuzz [--iters N] [--seed S]
        [--device-every K]

The native codec must build, as the script asserts.  ``run(...,
device="cpu")`` runs the device target's plain versions.
"""

from __future__ import annotations

import argparse
import time
import zlib
from collections import Counter

import numpy as np
import torch

from .. import api, native_backend
from ..compress import dynamic, pipeline
from ..decompress import decode, fsm
from ..device import resolve_device
from ..formats.deflate import deflate_compress_bound

ROW = 8192            # the device target's row (fuzz.py:137)
DEC_OUT = 16384       # a row's output room in the decoders
HOST_CAP = 1 << 16    # fuzz_decompress's out_cap
RESULTS = (api.SUCCESS, api.BAD_DATA, api.SHORT_OUTPUT,
           api.INSUFFICIENT_SPACE)
DEVICE_TIERS = {"static": pipeline.compress_chunks_static,
                "dyn1": dynamic.compress_chunks_dynamic}
DECODERS = ("K3 known size", "K3 unknown size", "F1")
WORDS = (b"alpha", b"beta", b"gamma", b"delta", b" ", b"\n", b"the")


def gen_data(rng: np.random.Generator, max_len: int = 1 << 16) -> bytes:
    """``scripts/fuzz.py::gen_data``: one of five classes, n in
    [0, max_len), and one call in 16 with max_len 1 MiB when max_len is
    at least 64 KiB (multi-block paths)."""
    if max_len >= (1 << 16) and int(rng.integers(0, 16)) == 0:
        max_len = 1 << 20
    n = int(rng.integers(0, max_len))
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == 1:
        period = int(rng.integers(1, 300))
        return (rng.integers(0, 256, period, np.uint8).tobytes()
                * (n // period + 1))[:n]
    if kind == 2:
        return bytes(n)
    if kind == 3:
        out = bytearray()
        while len(out) < n:
            out += WORDS[int(rng.integers(0, len(WORDS)))]
        return bytes(out[:n])
    return rng.integers(97, 105, n, np.uint8).tobytes()


def overwrite(rng: np.random.Generator, blob: bytearray) -> None:
    """1-7 random bytes of blob set to random values (fuzz.py:86-87; the
    value is drawn before the position)."""
    for _ in range(int(rng.integers(1, 8))):
        blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))


def decompress_case(rng: np.random.Generator) -> bytes:
    """fuzz_decompress's input (fuzz.py:79-88): garbage, or a corrupted
    zlib stream without its wrapper."""
    if rng.random() < 0.5:
        return rng.integers(0, 256, int(rng.integers(1, 4096)),
                            np.uint8).tobytes()
    blob = bytearray(zlib.compress(gen_data(rng, 4096),
                                   int(rng.integers(0, 10))))
    overwrite(rng, blob)
    return bytes(blob[2:-4])


def fuzz_decompress(blob: bytes) -> tuple:
    """fuzz_decompress's checks on blob: the ``Decompressor``'s raw,
    zlib and gzip 4-tuples (out_cap 64 KiB, unknown size)."""
    d = api.Decompressor()
    raw = d.deflate_decompress(blob, HOST_CAP, known_size=False)
    res, out = raw[0], raw[1]
    assert res in RESULTS, res
    try:
        oracle = zlib.decompressobj(-15).decompress(blob, HOST_CAP)
    except zlib.error:
        oracle = None
    if res == api.SUCCESS:
        # the acceptance rules follow zlib's, lax incomplete codes included
        assert oracle is not None, f"we SUCCESS-decode, zlib rejects: " \
                                   f"{blob.hex()}"
        m = min(len(out), len(oracle))
        assert out[:m] == oracle[:m], f"prefix mismatch: {blob.hex()}"
    wrapped = tuple(fn(blob, HOST_CAP, known_size=False)
                    for fn in (d.zlib_decompress, d.gzip_decompress))
    for r in wrapped:
        assert r[0] in RESULTS, r[0]
    return (raw,) + wrapped


def compress_case(rng: np.random.Generator, max_len: int = 1 << 16):
    """fuzz_compress's input (fuzz.py:115-118): (data, level, format)."""
    data = gen_data(rng, max_len)
    level = int(rng.integers(0, 13))
    fmt = ("deflate", "zlib", "gzip")[int(rng.integers(0, 3))]
    return data, level, fmt


def fuzz_compress(data: bytes, level: int, fmt: str) -> bytes:
    """fuzz_compress's checks: the ``Compressor`` blob within its bound,
    back through zlib and the ``Decompressor`` at known size."""
    blob = api.Compressor(level).compress(data, fmt)
    assert len(blob) <= deflate_compress_bound(len(data)) + 18
    if fmt == "deflate":
        assert zlib.decompressobj(-15).decompress(blob) == data
    elif fmt == "zlib":
        assert zlib.decompress(blob) == data
    else:
        assert zlib.decompress(blob, 31) == data
    res, out, _, _ = api.Decompressor().decompress(blob, len(data), fmt,
                                                   known_size=True)
    assert res == api.SUCCESS and out == data
    return blob


def device_case(rng: np.random.Generator):
    """The device target's row and its decoder rows: (data, [(kind,
    stream)]).  The row and the flipped bit are drawn as fuzz.py:136 and
    :166-168 draw them; the overwritten bytes and the cut follow."""
    data = gen_data(rng, ROW)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    stream = c.compress(data) + c.flush()
    rows = [("clean", stream)]
    if len(stream) > 8:
        bad = bytearray(stream)
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        rows.append(("bit flip", bytes(bad)))
    bad = bytearray(stream)
    overwrite(rng, bad)
    rows.append(("bytes overwritten", bytes(bad)))
    rows.append(("cut", stream[:int(rng.integers(0, len(stream)))]))
    return data, rows


def compress_row(data: bytes, dev: torch.device) -> None:
    """Static and dyn1 on one ``ROW``-byte row holding data
    (fuzz.py:136-150): each stream inflates through zlib to data."""
    buf = np.zeros((1, ROW), np.uint8)
    buf[0, :len(data)] = np.frombuffer(data, np.uint8)
    args = (torch.as_tensor(buf, device=dev),
            torch.tensor([len(data)], dtype=torch.int64, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev))
    for tier, entry in DEVICE_TIERS.items():
        w, t = entry(*args, device=dev)
        stream = pipeline.device_stream_to_bytes(w[0], int(t[0]))
        if zlib.decompressobj(-15).decompress(stream) != data:
            raise AssertionError(f"{tier} on a {len(data)}-byte row does not "
                                 f"round-trip through zlib: {data.hex()}")


def decode_rows(streams, sizes, dev: torch.device):
    """Every stream through each of ``DECODERS`` in one call: {decoder:
    (status, out, out_len, consumed)} as numpy arrays.  K3 decodes at
    known size (out_len ``sizes``) and at unknown size (out_len
    ``DEC_OUT``), F1 into ``DEC_OUT``."""
    comp, clen = decode.pack_streams(streams)
    rows = np.zeros((len(streams), max(int(clen.max()), 1)), np.uint8)
    for k, s in enumerate(streams):
        rows[k, :len(s)] = np.frombuffer(s, np.uint8)
    got = {}
    for name, known, olen in (("K3 known size", True, sizes),
                              ("K3 unknown size", False,
                               [DEC_OUT] * len(streams))):
        out, st, ol, cons = decode.decompress_chunks_words(
            comp.view(np.int32), clen, np.asarray(olen, np.int32), DEC_OUT,
            known_size=known, device=dev)
        got[name] = (st, out, ol, cons)
    out, ol, cons, res = fsm.decompress_chunks(rows, clen, DEC_OUT,
                                               device=dev)
    got["F1"] = (res, out, ol, cons)
    return {name: tuple(x.cpu().numpy() for x in four)
            for name, four in got.items()}


def check_rows(rows, got, plain=None) -> Counter:
    """The decoders' oracles on rows ([(kind, stream, data)]) and their
    results ``got`` (``decode_rows``); ``plain`` is the plain versions'
    results on the same rows, held equal in all four outputs.  Returns
    counts: rows, damaged rows, and per decoder its successes, failures,
    successes checked against zlib's prefix and successes zlib rejects."""
    counts = Counter(rows=len(rows),
                     damaged=sum(kind != "clean" for kind, _, _ in rows))
    for name in DECODERS:
        status, out, out_len, consumed = got[name]
        if plain is not None:
            for field, g, w in zip(("status", "out", "out_len", "consumed"),
                                   got[name], plain[name]):
                if not np.array_equal(g, w):
                    diff = np.flatnonzero((g != w).reshape(len(g), -1)
                                          .any(1)).tolist()
                    raise AssertionError(f"{name}: {field} differs from its "
                                         f"plain version in rows {diff}")
        for k, (kind, stream, data) in enumerate(rows):
            st, n = int(status[k]), int(out_len[k])
            if kind == "clean":
                if not (st == 0 and n == len(data)
                        and int(consumed[k]) == len(stream)
                        and out[k, :n].tobytes() == data):
                    raise AssertionError(f"{name}: a clean zlib-6 stream of "
                                         f"{len(data)} bytes gives status "
                                         f"{st}, out_len {n}, consumed "
                                         f"{int(consumed[k])}")
                continue
            counts[f"{name}: {'success' if st == 0 else 'failure'}"] += 1
            if st != 0:
                continue
            try:
                oracle = zlib.decompressobj(-15).decompress(stream, DEC_OUT)
            except zlib.error:
                counts[f"{name}: success zlib rejects"] += 1
                continue
            m = min(n, len(oracle))
            if out[k, :m].tobytes() != oracle[:m]:
                raise AssertionError(f"{name}: a {kind} row decodes to other "
                                     f"bytes than zlib's: {stream.hex()}")
            counts[f"{name}: success, zlib's prefix"] += 1
    return counts


def device_rows(cases, dev: torch.device) -> Counter:
    """Every case's rows ([(data, [(kind, stream)])]) through the decoders
    in one call each, held to the oracles (and, on the card, to the plain
    versions)."""
    rows = [(kind, s, data) for data, rs in cases for kind, s in rs]
    streams = [s for _, s, _ in rows]
    sizes = [len(data) for _, _, data in rows]
    got = decode_rows(streams, sizes, dev)
    plain = (None if dev.type == "cpu" else
             decode_rows(streams, sizes, torch.device("cpu")))
    return check_rows(rows, got, plain)


def run(iters: int = 200, seed: int = 0, device_every: int = 50,
        device=None, log=print) -> dict:
    """The script's loop: the host targets each trial and the device
    target every ``device_every`` trials (none at 0; then no device is
    needed), the decoders' rows of all device trials in one call a
    decoder at the end.  Raises on the first failure.  Returns the
    counts and the seconds."""
    assert native_backend.available(), "native codec must build"
    dev = resolve_device(device) if device_every else None
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    counts = Counter()
    cases = []
    for i in range(iters):
        blob = decompress_case(rng)
        counts[f"host decompress: result {fuzz_decompress(blob)[0][0]}"] += 1
        fuzz_compress(*compress_case(rng))
        counts["host compress"] += 1
        if device_every and i % device_every == 0:
            data, rs = device_case(rng)
            compress_row(data, dev)
            counts["device compress rows"] += 1
            cases.append((data, rs))
        if (i + 1) % 50 == 0:
            log(f"  {i + 1}/{iters} trials OK")
    t_dec = time.perf_counter()
    if cases:
        counts.update(device_rows(cases, dev))
    res = {"counts": dict(counts), "seconds": time.perf_counter() - t0,
           "decode_seconds": time.perf_counter() - t_dec,
           "row_lengths": [len(data) for data, _ in cases]}
    log(f"fuzz OK: {iters} trials x {3 if cases else 2} targets (seed "
        f"{seed}); {dict(sorted(counts.items()))}; "
        f"{res['seconds']:.3f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-every", type=int, default=50)
    args = ap.parse_args(argv)
    run(args.iters, args.seed, args.device_every)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
