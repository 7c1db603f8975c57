"""Randomized soak of the port's compress tiers on the card.

Counterpart of ``scripts/tpu_soak.py``: batches of B = 4 chunks of N =
1 MiB, each chunk of a random length in 1..N half the time and N
otherwise, of the script's five payload classes (random, periodic, zeros,
words, a ten-letter alphabet; ``crafted_scan.soak_payload``), drawn from
``np.random.default_rng(seed)`` exactly as the script draws them, so one
seed gives the script's payloads byte for byte.  The tiers take the
batches in turn, as the script cycles its engines; BFINAL is set on the
even chunks of a batch.  Every chunk:

1. round-trips through ``zlib.decompressobj(-15)``;
2. decodes through K3 (``decode.decompress_chunks_words``, known size)
   to its payload, status 0 and every byte consumed;
3. decodes through F1 (``fsm.decompress_chunks``) the same way;
4. with ``--pins FILE``: its total_bits and the SHA-256 of its bytes equal
   the JAX package's (``soak_pins.json``, written by
   ``tests/pin_soak.py``).

A chunk that is not final ends in a sync flush and no final block; the
decoders get it with ``FINAL_TAIL``, an empty final static block, after
it, as zlib's ``Z_FINISH`` after a sync flush ends a stream.

Run on the card from the repository root (the script's defaults: six
batches through static, dyn1 and dyn3)::

    python3 -m libdeflate_tpu_torch.experiments.soak [--batches N]
        [--seed S] [--tiers all|name,name,...] [--pins FILE]

``chip_smoke.py`` runs ``run`` with every tier, two batches a tier,
against the pins.  ``run(..., device="cpu")`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import time
import zlib

import numpy as np
import torch

from ..compress import dynamic, optimal, pipeline
from ..decompress import decode, fsm
from ..device import resolve_device
from .corpus import REPO
from .crafted_scan import soak_payload

N = 1 << 20
B = 4
SEED = 0xF00D
BATCHES = 6
KINDS = 5                      # payload classes of soak_payload
FINAL_TAIL = b"\x03\x00"       # an empty final static block
PINS = REPO / "libdeflate_tpu_torch" / "experiments" / "soak_pins.json"
TIERS = {"static": pipeline.compress_chunks_static,
         "dyn1": dynamic.compress_chunks_dynamic,
         "dyn2": dynamic.compress_chunks_dynamic2,
         "dyn3": dynamic.compress_chunks_dynamic3,
         "lean": optimal.compress_chunks_lean,
         "optfast": optimal.compress_chunks_optfast,
         "optimal": optimal.compress_chunks_optimal,
         "optimal2": optimal.compress_chunks_optimal2,
         "deep": optimal.compress_chunks_optimal_deep}
DEFAULT_TIERS = ("static", "dyn1", "dyn3")   # the script's three engines
# chunks of a few bytes in full rows, which random lengths almost never
# give: the segment split, the commit's truncation at a segment end and
# the word counts at their smallest
SHORT_LENGTHS = (0, 1, 2, 3, 63, 64, 65, 258)


def parse_tiers(spec: str) -> tuple[str, ...]:
    """``all`` or comma-separated names of ``TIERS``."""
    if spec == "all":
        return tuple(TIERS)
    names = tuple(s for s in spec.split(",") if s)
    bad = [s for s in names if s not in TIERS]
    if bad or not names:
        raise ValueError(f"unknown tiers {bad}; choose from {list(TIERS)}")
    return names


def draw_batches(batches: int, seed: int, b: int = B, n: int = N):
    """Each batch's payloads (a list of b bytes objects), drawn as
    ``scripts/tpu_soak.py:66-73`` draws them."""
    rng = np.random.default_rng(seed)
    for batch in range(batches):
        payloads = []
        for k in range(b):
            ln = int(rng.integers(1, n + 1)) if rng.random() < 0.5 else n
            payloads.append(soak_payload(rng, (batch * b + k) % KINDS, ln))
        yield payloads


def short_payloads() -> list[bytes]:
    """A payload of each of ``SHORT_LENGTHS``, the classes in turn."""
    rng = np.random.default_rng(SEED)
    return [soak_payload(rng, k % KINDS, ln)
            for k, ln in enumerate(SHORT_LENGTHS)]


def batch_arrays(payloads, n: int = N):
    """The entry's inputs: (uint8 [B, n] zero past each payload, int64 [B]
    lengths, bool [B] BFINAL on the even chunks)."""
    bufs = np.zeros((len(payloads), n), np.uint8)
    for i, p in enumerate(payloads):
        bufs[i, :len(p)] = np.frombuffer(p, np.uint8)
    lens = np.array([len(p) for p in payloads], np.int64)
    bfinal = np.array([i % 2 == 0 for i in range(len(payloads))])
    return bufs, lens, bfinal


def recipe(batches: int, seed: int, tiers, b: int = B, n: int = N) -> dict:
    return {"seed": seed, "batches": batches, "B": b, "N": n,
            "tiers": list(tiers)}


def decode_check(streams, bufs, lens, dev: torch.device) -> None:
    """Checks 2 and 3 on one batch: K3 (known size) and F1 decode each
    closed stream to its payload."""
    n = bufs.shape[1]
    want = torch.as_tensor(bufs, device=dev)
    clen = torch.tensor([len(s) for s in streams], dtype=torch.int32)
    olen = torch.as_tensor(lens, dtype=torch.int32)
    comp, _ = decode.pack_streams(streams)
    out, st, ol, cons = decode.decompress_chunks_words(
        comp.view(np.int32), clen, olen, -(-n // 4) * 4, device=dev)
    rows = np.zeros((len(streams), max(map(len, streams))), np.uint8)
    for k, s in enumerate(streams):
        rows[k, :len(s)] = np.frombuffer(s, np.uint8)
    f_out, f_ol, f_cons, f_res = fsm.decompress_chunks(rows, clen, n,
                                                       device=dev)
    for name, (o, status, ln, used) in (("K3", (out[:, :n], st, ol, cons)),
                                        ("F1", (f_out, f_res, f_ol, f_cons))):
        bad = [k for k in range(len(streams))
               if not (int(status[k]) == 0 and int(ln[k]) == lens[k]
                       and int(used[k]) == len(streams[k]))]
        if bad or not torch.equal(o, want):
            raise AssertionError(f"{name} does not decode chunks {bad or 'of '}"
                                 f"this batch to their payloads: status "
                                 f"{status.tolist()}, out_len {ln.tolist()}, "
                                 f"consumed {used.tolist()}")


def soak_batch(tier: str, payloads, dev: torch.device, n: int = N,
               call=None) -> tuple[list[int], list[str], int]:
    """One batch of payloads (each at most n bytes) through one tier and
    checks 1-3: (total_bits, SHA-256 of each chunk's bytes, bytes out).
    ``call(tier, entry, bufs, lengths, bfinal)`` runs the entry call
    (default ``entry(bufs, lengths, bfinal)``), so that a caller can
    record the kernels' inputs."""
    bufs, lens, bfinal = batch_arrays(payloads, n)
    entry = functools.partial(TIERS[tier], device=dev)
    args = (torch.as_tensor(bufs, device=dev),
            torch.as_tensor(lens, device=dev),
            torch.as_tensor(bfinal, device=dev))
    words, total_bits = (call(tier, entry, *args) if call else entry(*args))
    words, total_bits = words.cpu(), total_bits.cpu().tolist()
    closed, digests, nbytes = [], [], 0
    for i, p in enumerate(payloads):
        s = pipeline.device_stream_to_bytes(words[i], total_bits[i])
        if zlib.decompressobj(-15).decompress(s) != p:
            raise AssertionError(f"{tier}: chunk {i} ({len(p)} bytes) does "
                                 f"not round-trip through zlib")
        closed.append(s if bfinal[i] else s + FINAL_TAIL)
        digests.append(hashlib.sha256(s).hexdigest())
        nbytes += len(s)
    decode_check(closed, bufs, lens, dev)
    return total_bits, digests, nbytes


def run(batches: int = BATCHES, seed: int = SEED, tiers=DEFAULT_TIERS,
        device=None, pins: dict | None = None, b: int = B, n: int = N,
        call=None, log=print) -> dict:
    """Soak ``tiers`` (names of ``TIERS``, taken in turn a batch) on
    ``batches`` batches of b x n (``soak_batch``, with ``call``); raises
    on the first chunk that fails a check.  Returns the chunk count, the
    lengths, per-chunk total_bits and digests, and the seconds."""
    dev = resolve_device(device)
    tiers = tuple(tiers)
    if pins is not None and pins["recipe"] != recipe(batches, seed, tiers,
                                                     b, n):
        raise ValueError(f"the pins' recipe {pins['recipe']} is not this "
                         f"run's {recipe(batches, seed, tiers, b, n)}")
    t0 = time.perf_counter()
    res = {"chunks": 0, "lengths": [], "total_bits": [], "sha256": []}
    for batch, payloads in enumerate(draw_batches(batches, seed, b, n)):
        tier = tiers[batch % len(tiers)]
        total_bits, digests, nbytes = soak_batch(tier, payloads, dev, n,
                                                 call)
        if pins is not None:
            want = (pins["total_bits"][batch], pins["sha256"][batch])
            if (total_bits, digests) != want:
                raise AssertionError(f"{tier}, batch {batch}: total_bits "
                                     f"{total_bits} and digests differ from "
                                     f"the JAX package's {want[0]}")
        lens = [len(p) for p in payloads]
        res["chunks"] += len(payloads)
        res["lengths"].append(lens)
        res["total_bits"].append(total_bits)
        res["sha256"].append(digests)
        log(f"  batch {batch + 1}/{batches} {tier} OK: lengths {lens}, "
            f"kinds {[(batch * b + k) % KINDS for k in range(b)]}, "
            f"{nbytes} bytes out"
            + (", pins equal" if pins is not None else ""))
    res["seconds"] = time.perf_counter() - t0
    res["tiers"] = list(tiers)
    log(f"soak OK: {res['chunks']} chunks across {len(tiers)} tiers "
        f"({', '.join(tiers)}) vs zlib, K3 and F1"
        + (" and the JAX pins" if pins is not None else "")
        + f" (seed {seed:#x}); {res['seconds']:.3f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=BATCHES)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--tiers", default=",".join(DEFAULT_TIERS),
                    help="all, or names of " + ", ".join(TIERS))
    ap.add_argument("--pins", default=None,
                    help="a soak_pins.json to hold every chunk to")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print("device:", torch.cuda.get_device_name(dev))
    pins = None if args.pins is None else json.loads(open(args.pins).read())
    run(args.batches, args.seed, parse_tiers(args.tiers), dev, pins)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
