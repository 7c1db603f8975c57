"""Pin the JAX package's whole-file gzip bytes of the chunk-parallel codec.

Writes ``libdeflate_tpu_torch/experiments/file_codec_pins.json``: for
each level L of 0, 1, 6, 9 and 12, the length and SHA-256 of
``libdeflate_tpu.parallel.file_codec.gzip_compress_dp(corpus,
chunk_size=1 MiB, level=L)`` over the 16 MiB corpus of
``libdeflate_tpu_torch/experiments/corpus.py``, with the per-chunk
sizes it gathered (``all_bits``) and the seconds each level took.
``chip_smoke.py`` holds the port's gzip bytes on the card to these
digests without importing JAX.

The mesh is one CPU device, and its ``compress_chunks_dp`` runs one
chunk a call: every chunk is compressed on its own (the shard split and
the vmap change no chunk's bits), and one 1 MiB chunk at a time keeps
the DP levels within a few GiB of host memory, where sixteen at once
would not.  The assembly, the stored fallback, the checksum combine,
the header and the trailer are the JAX package's own.

Run from the repository root on the CPU (about 15 minutes):

    JAX_PLATFORMS=cpu python tests/pin_file_codec.py [level ...]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
import zlib
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from libdeflate_tpu.parallel import file_codec, mesh  # noqa: E402
from libdeflate_tpu_torch.experiments import corpus as pc  # noqa: E402

OUT = (REPO / "libdeflate_tpu_torch" / "experiments"
       / "file_codec_pins.json")
COMMAND = "JAX_PLATFORMS=cpu python tests/pin_file_codec.py"
LEVELS = (0, 1, 6, 9, 12)


def one_chunk_a_call(whole, gathered: list):
    """``whole`` (``mesh.compress_chunks_dp``) run on one chunk a call, its
    outputs concatenated; each call's ``all_bits`` is appended to
    ``gathered``."""

    def compress_chunks_dp(m, bufs, lengths, bfinal, level=1):
        outs = [[np.asarray(x) for x in whole(
            m, bufs[i:i + 1], lengths[i:i + 1], bfinal[i:i + 1], level)]
            for i in range(len(bufs))]
        res = tuple(np.concatenate([o[k] for o in outs]) for k in range(5))
        gathered.append(res[4])
        return res

    return compress_chunks_dp


def main() -> int:
    only = {int(a) for a in sys.argv[1:]}
    corpus = pc.make_corpus(pc.CORPUS_BYTES)
    m = mesh.make_chunk_mesh(jax.devices()[:1])
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    pins = old.get("gzip", {})
    whole = mesh.compress_chunks_dp
    try:
        for level in LEVELS:
            if only and level not in only:
                continue
            gathered: list = []
            mesh.compress_chunks_dp = one_chunk_a_call(whole, gathered)
            t0 = time.perf_counter()
            out = file_codec.gzip_compress_dp(corpus, m, chunk_size=pc.CHUNK,
                                              level=level)
            secs = round(time.perf_counter() - t0, 1)
            if zlib.decompress(out, 31) != corpus:
                raise AssertionError(f"level {level}: the gzip stream does "
                                     f"not inflate to the corpus")
            pins[str(level)] = {
                "bytes": len(out),
                "sha256": hashlib.sha256(out).hexdigest(),
                "all_bits": [int(b) for b in gathered[0]],
                "seconds": secs}
            print(f"level {level}: {len(out)} bytes, "
                  f"{pins[str(level)]['sha256']}, {secs} s", flush=True)
            OUT.write_text(json.dumps({
                "command": COMMAND,
                "corpus": (f"experiments/corpus.py "
                           f"make_corpus({pc.CORPUS_BYTES})"),
                "chunk": pc.CHUNK,
                "gzip": dict(sorted(pins.items(), key=lambda kv: int(kv[0]))),
            }, indent=1) + "\n")
    finally:
        mesh.compress_chunks_dp = whole
    return 0


if __name__ == "__main__":
    sys.exit(main())
