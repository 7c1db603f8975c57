"""Checksum and decode throughput on the card.

Counterpart of ``scripts/exp_checksum_decode.py``:

- ``ops.checksums.crc32_chunks`` and ``adler32_chunks`` on a resident
  batch of 64 random rows of 4 MiB (256 MiB, seed 11), every 16th row
  checked against zlib; GB/s from the median of 5 calls on the host
  clock, each ending in ``torch.cuda.synchronize()``, and by CUDA events
  with the card's queue filled before the call (``timing.stage_ms``);
- the decoder K3 (``decompress_chunks_words``, known size) on the zlib
  level-6 streams of the 16 chunks of the corpus (``experiments/
  corpus.py``), in one call of B = 16; every chunk checked against the
  corpus; MB/s from the median of 3 calls.

Runs on CUDA (raising without it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_checksum_decode
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np
import torch

from ..decompress.decode import decompress_chunks_words, pack_streams
from ..device import resolve_device
from ..ops.checksums import adler32_chunks, crc32_chunks
from . import corpus as pc
from .driver_common import device_args
from .timing import describe, ms_text, stage_ms

ROWS, ROW_BYTES = 64, 1 << 22
DEC_CHUNKS = 16


def checksums(dev: torch.device, rows: int = ROWS, row_bytes: int = ROW_BYTES,
              reps: int = 5, log=print) -> dict:
    rng = np.random.default_rng(11)
    bufs_np = rng.integers(0, 256, size=(rows, row_bytes), dtype=np.uint8)
    bufs = torch.as_tensor(bufs_np, device=dev)
    lengths = torch.full((rows,), row_bytes, dtype=torch.int64, device=dev)
    out = {}
    for name, fn, ref in (("CRC-32 ", crc32_chunks, zlib.crc32),
                          ("Adler32", adler32_chunks, zlib.adler32)):
        got = fn(bufs, lengths, device=dev).cpu()
        ok = all(int(got[i]) == ref(bufs_np[i].tobytes()) & 0xFFFFFFFF
                 for i in range(0, rows, 16))
        host, events = stage_ms(lambda: fn(bufs, lengths, device=dev), dev,
                                reps)
        nbytes = rows * row_bytes
        out[name.strip()] = {"ok": ok, "host_ms": host, "event_ms": events,
                             "gbps": nbytes / host / 1e6}
        ev_rate = ("" if events is None
                   else f", {nbytes / events / 1e6:8.2f} GB/s by events")
        log(f"{name} {nbytes / host / 1e6:8.2f} GB/s{ev_rate} "
            f"({nbytes >> 20} MiB; host {ms_text(host)}, events "
            f"{ms_text(events)}) ({'OK' if ok else 'MISMATCH'})", flush=True)
    return out


def decode(dev: torch.device, nchunks: int = DEC_CHUNKS,
           chunk: int = pc.CHUNK, reps: int = 3, log=print) -> dict:
    data = pc.make_corpus(max(pc.CORPUS_BYTES, nchunks * chunk))
    chunks = [data[i * chunk:(i + 1) * chunk] for i in range(nchunks)]
    streams = [pc.zlib_raw(ch) for ch in chunks]
    comp, clen = pack_streams(streams)
    words = torch.as_tensor(comp.view(np.int32), device=dev)
    clen = torch.as_tensor(clen, device=dev)
    olen = torch.full((nchunks,), chunk, dtype=torch.int32, device=dev)

    def call():
        return decompress_chunks_words(words, clen, olen, chunk, device=dev)

    out, status, out_len, _ = call()
    out = out.cpu().numpy()
    ok = all(int(status[k]) == 0 and out[k].tobytes() == chunks[k]
             for k in range(nchunks))
    host, events = stage_ms(call, dev, reps)
    rate = nchunks * chunk / host / 1e3
    log(f"K3 decode {rate:8.2f} MB/s ({nchunks} zlib-6 chunks of {chunk} "
        f"bytes; host {ms_text(host)}, events {ms_text(events)}) "
        f"({'OK' if ok else 'MISMATCH'})", flush=True)
    return {"ok": ok, "host_ms": host, "event_ms": events, "mbps": rate}


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--row-bytes", type=int, default=ROW_BYTES)
    ap.add_argument("--chunks", type=int, default=DEC_CHUNKS)
    ap.add_argument("--chunk", type=int, default=pc.CHUNK)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe(dev), flush=True)
    cs = checksums(dev, args.rows, args.row_bytes)
    dec = decode(dev, args.chunks, args.chunk)
    return 0 if all(v["ok"] for v in cs.values()) and dec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
