"""Traffic kind "compress": whole files through the gzip entry, back to
back, as libdeflate's ``benchmark`` compresses.

A call is ``gzip_compress_dp(file, mesh, chunk_bytes, level)`` over the
cell's mesh; the window takes the mix's files in turn.  Every member the
window returns is kept and judged after it by ``reference.gzip_member``:
a member equal byte for byte to one already judged for the same file
shares its verdict, so a program that returns the same bytes each time
is inflated once a file.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

from .. import gen
from ..reference import controls, gzip_member
from ..stats import window_rate


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices, system: str):
        self.level, self.chunk = cfg["level"], cfg["chunk_bytes"]
        self.files = gen.make_files(mix, seed)
        self.members: list[tuple[int, bytes]] = []
        if system == "port":
            from libdeflate_tpu_torch.parallel import file_codec, mesh
            self.mesh = mesh.make_chunk_mesh(devices)
            self.compress = lambda data: file_codec.gzip_compress_dp(
                data, self.mesh, self.chunk, self.level)
        elif system == "control":
            self.pool = ThreadPoolExecutor(8)
            self.compress = lambda data: controls.gzip_xor_crc(
                data, self.chunk, self.level, self.pool)
        else:
            raise ValueError(f"unknown system {system!r}")

    def warmup(self) -> None:
        """One call on each file: every shape the window uses."""
        for data in self.files:
            self.compress(data)

    def call(self, i: int) -> tuple[int, int]:
        k = i % len(self.files)
        member = self.compress(self.files[k])
        self.members.append((k, member))
        return len(self.files[k]), len(member)

    def close(self) -> None:
        if hasattr(self, "pool"):
            self.pool.shutdown()

    def judge(self, log) -> tuple[dict, int]:
        """The numbers compared, each (value, limit), and the calls that
        failed."""
        crcs = [zlib.crc32(f) for f in self.files]
        verdicts: dict[tuple[int, bytes], str | None] = {}
        wrong = over = 0
        for k, member in self.members:
            if (k, member) not in verdicts:
                why = gzip_member.check(member, self.files[k], crcs[k])
                verdicts[k, member] = why
                if why:
                    log(f"member of file {k}: {why}")
            wrong += verdicts[k, member] is not None
            over += gzip_member.over_bound(member, len(self.files[k]),
                                           self.chunk)
        log(f"judged {len(self.members)} members, {len(verdicts)} distinct")
        return ({"wrong_members": (wrong, 0),
                 "over_bound_members": (over, 0)}, wrong)

    @staticmethod
    def end_to_end(calls, start: float) -> dict:
        nin, seconds = window_rate(calls, start, 2)
        return {"compress_GBps": nin / seconds / 1e9,
                "ratio": sum(c[3] for c in calls) / nin}
