"""Checksum profile on the card: K passes over a resident 256 MiB batch in
one CUDA graph, and the CRC's sub-stages.

Counterpart of ``scripts/exp_crc_profile.py``, where K passes ride one
jitted ``fori_loop`` with a different initial value a pass: here the K
passes (K = 6, inits i and 1 + i) are captured in one CUDA graph and the
graph is replayed, so one launch carries them all.  Lines:

- Adler-32 and CRC-32 (``ops.checksums.adler32_rows``, ``crc32_rows``);
- the CRC's sub-stages on the port's own layout (``crc32_rows``): the bit
  planes of every 2048-byte block as float32 (summed), the planes times
  the block matrix as the port computes it (float32 operands with TF32
  allowed, exact: CUDA has no int8 ``torch.matmul``, so this stands where
  the script times an int8 product), the same product on bf16 operands
  with float32 sums (``torch.mm(..., out_dtype=torch.float32)``; products
  of 0/1 summed in float32 are exact), and a full reduce of the bytes
  (the Adler sums' ceiling).

GB/s is K * 256 MiB over the median of 3 replays on the host clock, each
ending in ``torch.cuda.synchronize()``; the replay's CUDA-event time
beside it.  Runs on CUDA (raising without it) unless ``--device cpu``
(there the K passes run as a loop, with no graph):

    python -m libdeflate_tpu_torch.experiments.exp_crc_profile
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import checksums as cs
from ..ops.crc32_math import CRC_BLOCK
from .driver_common import device_args
from .timing import describe, ms_text, stage_ms

ROWS, ROW_BYTES = 64, 1 << 22
K = 6


def planes(bufs: torch.Tensor) -> torch.Tensor:
    """The CRC's bit planes: [blocks, 8 * 2048] float32 0/1, byte-major
    (``crc32_rows``' operand)."""
    B, n = bufs.shape
    bits = (bufs.reshape(B * (n // CRC_BLOCK), CRC_BLOCK, 1)
            >> torch.arange(8, dtype=torch.uint8, device=bufs.device)) & 1
    return bits.reshape(-1, 8 * CRC_BLOCK).to(torch.float32)


def bf16_product(lhs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """lhs @ mat on bf16 operands with float32 sums (on the CPU, the float
    product of the bf16-rounded operands: the same values)."""
    a, b = lhs.to(torch.bfloat16), mat.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def substages(bufs, lengths):
    """name -> one pass of fn(i) (i the pass number), as the script's."""
    B = bufs.shape[0]
    dev = bufs.device
    mat = cs._matrices(dev)[0]

    def adler(i):
        return cs.adler32_rows(bufs, lengths,
                               torch.full((B,), 1 + i, device=dev),
                               device=dev)

    def crc(i):
        return cs.crc32_rows(bufs, lengths, torch.full((B,), i, device=dev),
                             device=dev)

    def planes_sum(i):
        return planes(bufs + i).sum()

    def planes_f32(i):
        return torch.matmul(planes(bufs + i), mat).sum()

    def planes_bf16(i):
        return bf16_product(planes(bufs + i), mat).sum()

    def reduce_u8(i):
        return (bufs + i).to(torch.int32).sum()

    return {"Adler32": adler, "CRC-32": crc,
            "  planes (+sum)": planes_sum,
            "  planes+f32/TF32 product (exact)": planes_f32,
            "  planes+bf16 product (f32 sums)": planes_bf16,
            "  u8 full-reduce": reduce_u8}


def k_passes(one, k: int, dev: torch.device):
    """A callable running k passes of one(i): the replay of a CUDA graph
    holding them on CUDA, a loop elsewhere."""
    if dev.type != "cuda":
        return lambda: [one(i) for i in range(k)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        one(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [one(i) for i in range(k)]
    keep = (graph, outs)
    return lambda: keep[0].replay()


def run(dev: torch.device, rows: int = ROWS, row_bytes: int = ROW_BYTES,
        k: int = K, reps: int = 3, log=print) -> list[dict]:
    rng = np.random.default_rng(5)
    bufs = torch.as_tensor(rng.integers(0, 256, size=(rows, row_bytes),
                                        dtype=np.uint8), device=dev)
    lengths = torch.full((rows,), row_bytes, dtype=torch.int64, device=dev)
    nbytes = k * rows * row_bytes
    log(f"B={rows} x {row_bytes} bytes, K={k} passes a "
        f"{'graph replay' if dev.type == 'cuda' else 'loop'} -> "
        f"{nbytes >> 20} MiB; {describe(dev)}", flush=True)
    out = []
    for name, one in substages(bufs, lengths).items():
        fn = k_passes(one, k, dev)
        host, events = stage_ms(fn, dev, reps)
        out.append({"name": name.strip(), "host_ms": host,
                    "event_ms": events, "gbps": nbytes / host / 1e6})
        ev_rate = ("" if events is None
                   else f"  {nbytes / events / 1e6:8.2f} GB/s by events")
        log(f"{name:36s} {nbytes / host / 1e6:8.2f} GB/s{ev_rate} (host "
            f"{ms_text(host)}, events {ms_text(events)})", flush=True)
        del fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--row-bytes", type=int, default=ROW_BYTES)
    ap.add_argument("--k", type=int, default=K)
    args = ap.parse_args(argv)
    run(resolve_device(args.device), args.rows, args.row_bytes, args.k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
