"""Traffic kind "decompress": one file of independent raw-DEFLATE chunk
streams decoded through the mesh, back to back, as libdeflate's
``benchmark`` decompresses.

Set-up makes the mix's file and compresses each ``chunk_bytes`` chunk
alone by zlib at the configuration's level (a thread pool), into one
uint8 [chunks, longest stream] tensor on the host.  A call is
``decompress_chunks_dp(mesh, bufs, in_lens, out_lens, chunk_bytes)``
with the default decoder, its outputs copied to the host into a buffer
the caller allocated once, as libdeflate's ``benchmark`` decompresses
into one buffer for the whole run.  On a card the caller holds the
streams and its buffers in pinned memory, as a caller of a GPU codec
does: through pageable memory the copies time the host's page faults and
memcpy (on an H100 host, a fresh array a call made a call 122-137 ms in
place of ~49, and a reused pageable buffer gave rates 10% apart from
one process to the next).
Every call's statuses, lengths and bytes consumed are judged; the bytes
of ``sample_calls`` calls drawn from the seed (a reservoir over the
window) are compared with the file.  The reservoir keeps its calls'
buffers, so the caller holds ``sample_calls`` + 1 buffers, all made in
set-up.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import torch

from .. import gen
from ..reference import controls
from ..stats import window_rate


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices, system: str):
        self.chunk = cfg["chunk_bytes"]
        data = gen.make_files(mix, seed)[0]
        if len(data) % self.chunk:
            raise ValueError("the decode file must be whole chunks")
        self.want = np.frombuffer(data, np.uint8).reshape(-1, self.chunk)
        streams = gen.chunk_streams(data, self.chunk, cfg["level"])
        pin = devices[0].type == "cuda"
        self.bufs = torch.zeros((len(streams), max(map(len, streams))),
                                dtype=torch.uint8, pin_memory=pin)
        for i, s in enumerate(streams):
            self.bufs[i, :len(s)] = torch.frombuffer(bytearray(s),
                                                     dtype=torch.uint8)
        self.in_lens = np.array([len(s) for s in streams], np.int32)
        self.out_lens = np.full(len(streams), self.chunk, np.int32)
        self.rng = gen.rng_of(seed, 1 << 20)
        self.k = mix["sample_calls"]
        self.host = [torch.zeros(self.want.shape, dtype=torch.uint8,
                                 pin_memory=pin) for _ in range(self.k + 1)]
        self.free = list(range(len(self.host)))
        self.spare = self.free.pop()
        self.sample: list[tuple[int, int]] = []   # (call, buffer)
        self.reports: list[tuple] = []
        if system == "port":
            from libdeflate_tpu_torch.parallel import mesh
            self.mesh = mesh.make_chunk_mesh(devices)

            def decode(dst):
                out, lens, consumed, status, _ = mesh.decompress_chunks_dp(
                    self.mesh, self.bufs, self.in_lens, self.out_lens,
                    self.chunk)
                dst.copy_(out)
                return lens.cpu(), consumed.cpu(), status.cpu()
            self.decode = decode
        elif system == "control":
            self.pool = multiprocessing.get_context("spawn").Pool(8)

            def decode(dst):
                out, *rest = controls.decode_split(streams, self.chunk,
                                                   self.pool)
                dst.copy_(torch.from_numpy(out))
                return rest
            self.decode = decode
        else:
            raise ValueError(f"unknown system {system!r}")

    def warmup(self) -> None:
        self.decode(self.host[self.spare])

    def call(self, i: int) -> tuple[int, int]:
        lens, consumed, status = self.decode(self.host[self.spare])
        self.reports.append((np.asarray(lens), np.asarray(consumed),
                             np.asarray(status)))
        # a reservoir of the window's outputs, drawn from the seed: a kept
        # call keeps its buffer, and the one it evicts becomes the spare
        j = i if i < self.k else int(self.rng.integers(0, i + 1))
        if j < self.k:
            if i < self.k:
                self.sample.append((i, self.spare))
                self.spare = self.free.pop()
            else:
                self.sample[j], self.spare = (i, self.spare), self.sample[j][1]
        return int(self.in_lens.sum()), int(self.out_lens.sum())

    def close(self) -> None:
        if hasattr(self, "pool"):
            self.pool.close()
            self.pool.join()

    def judge(self, log) -> tuple[dict, int]:
        """The numbers compared, each (value, limit), and the calls that
        failed."""
        bad = [np.zeros(len(self.in_lens), bool) for _ in self.reports]
        for b, (lens, consumed, status) in zip(bad, self.reports):
            b |= (status != 0) | (lens != self.out_lens) | (
                consumed != self.in_lens)
        for i, buf in self.sample:
            rows = ~(self.host[buf].numpy() == self.want).all(axis=1)
            bad[i] |= rows
            if rows.any():
                log(f"call {i}: chunks {np.flatnonzero(rows).tolist()[:16]} "
                    f"differ from the file")
        log(f"judged {len(self.reports)} calls' statuses, lengths and bytes "
            f"consumed, and the bytes of calls "
            f"{sorted(i for i, _ in self.sample)}")
        wrong = int(sum(b.sum() for b in bad))
        return {"wrong_chunks": (wrong, 0)}, sum(bool(b.any()) for b in bad)

    @staticmethod
    def end_to_end(calls, start: float) -> dict:
        nout, seconds = window_rate(calls, start, 3)
        return {"decompress_GBps": nout / seconds / 1e9}
