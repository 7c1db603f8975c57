"""The second corpus's text gap, lean tier against the native level 6,
split into parse loss and entropy-coding loss.

Counterpart of ``scripts/exp_text_gap_diag.py``: for the first chunks of
the second corpus's text part (``corpus.make_corpus2``, 1 MiB each), the
native codec's level-6 stream (the port's ``api.Compressor(6)``) and the
lean tier's (``compress_chunks_optimal_with`` at depth 6, one cost pass,
no content pass, 16-byte payloads, LEN_LADDER_DENSE2, raw C, no second
stride round, 11-bit codes: ``parse_chunk_optimal`` and
``emit_dynamic_block(refine_passes=0)`` in the script, one chunk a call,
not final) are decoded back to their items by the script's own host
tokenizer (``tokenize``, ``stream_stats``: blocks, header bits,
literals, matches and their cover, length classes, symbol and extra
bits), and both sets of statistics printed beside each other.  The lean
stream is checked through zlib first.  Runs on CUDA (raising without
it) unless ``--device cpu``:

    python -m libdeflate_tpu_torch.experiments.exp_text_gap_diag [nchunks]
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np
import torch

from ..api import Compressor
from ..compress.kernels import LEN_LADDER_DENSE2
from ..compress.optimal import compress_chunks_optimal_with
from ..compress.pipeline import device_stream_to_bytes
from ..device import resolve_device
from . import corpus as pc
from .driver_common import device_args
from .timing import describe

CHUNK = pc.CHUNK
LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
            use_content=False, use_wide=False, ladder=LEN_LADDER_DENSE2,
            ext_c=False, strides2=(), refine_passes=0)


LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
            43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LEN_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
             4, 4, 4, 4, 5, 5, 5, 5, 0]
OFF_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
            257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
            12289, 16385, 24577]
OFF_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
             9, 9, 10, 10, 11, 11, 12, 12, 13, 13]
PERM = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


class _BR:
    def __init__(self, data):
        self.d, self.pos, self.buf, self.n = data, 0, 0, 0

    def need(self, k):
        while self.n < k:
            b = self.d[self.pos] if self.pos < len(self.d) else 0
            self.pos += 1
            self.buf |= b << self.n
            self.n += 8

    def take(self, k):
        self.need(k)
        v = self.buf & ((1 << k) - 1)
        self.buf >>= k
        self.n -= k
        return v

    def bitpos(self):
        return self.pos * 8 - self.n


def _mkdec(lens):
    """(code, len) -> sym decode dict keyed by (len, code)."""
    out = {}
    code = 0
    for l in range(1, 16):
        for s, ln in enumerate(lens):
            if ln == l:
                out[(l, code)] = s
                code += 1
        code <<= 1
    return out


def _dsym(br, dec):
    code = 0
    for l in range(1, 16):
        code = (code << 1) | br.take(1)
        if (l, code) in dec:
            return dec[(l, code)], l
    raise ValueError("bad code")


def tokenize(stream: bytes):
    """The script's tokenizer.  Yield ('block', hdr_bits) / ('lit', sym_bits) /
    ('match', len, dist, sym_bits, extra_bits) for a raw DEFLATE stream."""
    br = _BR(stream)
    while True:
        if br.pos >= len(br.d):       # ran off the stream (non-final chunk)
            return
        h0 = br.bitpos()
        final = br.take(1)
        btype = br.take(2)
        if btype == 0:
            br.need((8 - (br.bitpos() & 7)) & 7)
            br.take((8 - (br.bitpos() & 7)) & 7)
            ln = br.take(16)
            br.take(16)
            yield ("block", br.bitpos() - h0)
            for _ in range(ln):
                br.take(8)
                yield ("lit", 8)
        else:
            if btype == 1:
                ll = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
                dl = [5] * 30
            else:
                hlit = br.take(5) + 257
                hdist = br.take(5) + 1
                hclen = br.take(4) + 4
                plens = [0] * 19
                for i in range(hclen):
                    plens[PERM[i]] = br.take(3)
                pdec = _mkdec(plens)
                lens = []
                while len(lens) < hlit + hdist:
                    s, _ = _dsym(br, pdec)
                    if s < 16:
                        lens.append(s)
                    elif s == 16:
                        r = 3 + br.take(2)
                        lens += [lens[-1]] * r
                    elif s == 17:
                        lens += [0] * (3 + br.take(3))
                    else:
                        lens += [0] * (11 + br.take(7))
                ll, dl = lens[:hlit], lens[hlit:]
            ldec, ddec = _mkdec(ll), _mkdec(dl)
            yield ("block", br.bitpos() - h0)
            while True:
                s, sb = _dsym(br, ldec)
                if s < 256:
                    yield ("lit", sb)
                elif s == 256:
                    break
                else:
                    sl = s - 257
                    eb = LEN_EXTRA[sl]
                    ln = LEN_BASE[sl] + br.take(eb)
                    ds, dsb = _dsym(br, ddec)
                    deb = OFF_EXTRA[ds]
                    dist = OFF_BASE[ds] + br.take(deb)
                    yield ("match", ln, dist, sb + dsb, eb + deb)
        if final:
            return


def stream_stats(stream: bytes):
    """(nblocks, nlit, nmatch, match_bytes, sym_bits, extra_bits,
    hdr_bits, len_hist_summary, dist_summary)."""
    stats = dict(blocks=0, lits=0, matches=0, mbytes=0, sym_bits=0,
                 extra_bits=0, hdr_bits=0, len_sum=0, dist_log_sum=0.0,
                 len3=0, len4_8=0, len9_32=0, len33p=0)
    for tok in tokenize(stream):
        kind = tok[0]
        if kind == "block":
            stats["blocks"] += 1
            stats["hdr_bits"] += tok[1]
        elif kind == "lit":
            stats["lits"] += 1
            stats["sym_bits"] += tok[1]
        elif kind == "match":
            ln, dist, sbits, ebits = tok[1], tok[2], tok[3], tok[4]
            stats["matches"] += 1
            stats["mbytes"] += ln
            stats["sym_bits"] += sbits
            stats["extra_bits"] += ebits
            stats["len_sum"] += ln
            stats["dist_log_sum"] += float(np.log2(max(dist, 1)))
            if ln == 3:
                stats["len3"] += 1
            elif ln <= 8:
                stats["len4_8"] += 1
            elif ln <= 32:
                stats["len9_32"] += 1
            else:
                stats["len33p"] += 1
    return stats


def lean_stream(chunk: bytes, dev: torch.device) -> bytes:
    """The lean tier's stream of one chunk, not final."""
    b = np.frombuffer(chunk, np.uint8)[None]
    w, t = compress_chunks_optimal_with(
        b, np.array([len(chunk)]), np.array([False]), device=dev, **LEAN)
    return device_stream_to_bytes(w[0].cpu(), int(t[0]))


def diag(chunks, dev: torch.device, log=print) -> list[dict]:
    """Both streams' statistics a chunk: [{"native": ..., "device":
    ...}]."""
    comp6 = Compressor(6)
    out = []
    for k, ch in enumerate(chunks):
        nat = bytes(comp6.deflate_compress(ch))
        dv = lean_stream(ch, dev)
        if zlib.decompressobj(-15).decompress(dv) != ch:
            raise AssertionError(f"chunk {k}: the lean stream does not "
                                 f"inflate to the chunk")
        sn, sd = stream_stats(nat), stream_stats(dv)
        out.append({"native": sn, "device": sd, "native_bytes": len(nat),
                    "device_bytes": len(dv)})
        log(f"chunk {k}: native {len(nat)} B vs device {len(dv)} B "
            f"({(len(dv) - len(nat)) / len(ch) * 100:+.3f}pp)", flush=True)
        for tag, s in (("native-L6", sn), ("device-lean", sd)):
            cov = s["mbytes"] / len(ch) * 100
            avl = s["len_sum"] / max(s["matches"], 1)
            avd = s["dist_log_sum"] / max(s["matches"], 1)
            log(f"  {tag:12s} blocks={s['blocks']:3d} "
                f"hdr={s['hdr_bits'] / 8:7.0f}B "
                f"lits={s['lits']:7d} matches={s['matches']:7d} "
                f"cover={cov:5.1f}% avglen={avl:5.1f} "
                f"avglog2d={avd:4.1f}", flush=True)
            log(f"               len3={s['len3']} len4-8={s['len4_8']} "
                f"len9-32={s['len9_32']} len33+={s['len33p']} "
                f"symB={s['sym_bits'] // 8} extraB={s['extra_bits'] // 8}",
                flush=True)
    return out


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    ap.add_argument("nchunks", nargs="?", type=int, default=2)
    ap.add_argument("--total", type=int, default=pc.CORPUS_BYTES)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus = pc.make_corpus2(args.total)
    text = corpus[: 4 * (len(corpus) // 10)]
    chunks = [text[i * args.chunk:(i + 1) * args.chunk]
              for i in range(args.nchunks)]
    print(describe(dev), flush=True)
    diag(chunks, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
