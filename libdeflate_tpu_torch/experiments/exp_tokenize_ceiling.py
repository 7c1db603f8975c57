"""The tokenize-only ceiling of the scalar decoder (K4).

Counterpart of ``scripts/exp_tokenize_ceiling.py``: how fast can the
decoder's Huffman token loop go -- table builds, bit cursor, entry
resolution, offset decode, validation -- with no output written?  Set
beside K3's full decode on the same streams, it splits K3's time into the
token loop and the output writes and copies.

- ``tokenize_chunks`` is the script's ``tokenize_chunks`` (lines 349-393):
  padded compressed words [B, W] -> (status, op, acc), int32 [B] each.
  For CUDA tensors it launches ``csrc/tokenize_chunks.cu``, which replaces
  the Pallas kernel ``_tok_kernel`` (46-346); for CPU tensors it runs
  ``tokenize_chunks_plain``.  Launches are counted in its ``launches``.
- ``ceiling_table`` and ``main`` are the script's ``main`` (416-462): MB/s
  of output per corpus class and variant, with K3's rate beside each class.
- What holds the chain, for ``PERF.md``: ``chain_counts`` (the plain
  version's tokens and table lookups per chunk), ``shared_load_latency``
  (the card's dependent shared-memory load) and ``phase_cycles`` (K4's
  clock64() cycles per chunk, in all and in the table setups).

The variants: tok1 the burst/item loop with the output deleted; tok2, tok4
and tok8 unroll the burst (select-committed steps per loop test); tokst and
tokst4 store one token per burst lookup and per item in a buffer.  All give
the same outputs.  ``acc`` is an XOR digest of the tokens, to be compared
modulo 2**32 (a burst literal XORs its raw 32-bit table entry).

The plain version and the kernel follow ``_tok_kernel``, which differs from
K3: a stored block is one token, checked only for NLEN and out_len, that
jumps the bit cursor by 32 + 8 * LEN with no staging bound; the burst
budget has no 32 KiB boundary; the offset lookup runs for every item.  Where
the reference is undefined the port takes K3's choices
(``decompress/decode.py``): a chunk outside the input contract (negative
comp_len, fewer than STAGE_W words of padding) is BAD_DATA with op 0 and
acc 0; a word read past the padded row reads word W_pad - 1, and a block
header there is BAD_DATA.

Run (on a CUDA machine): ``python -m
libdeflate_tpu_torch.experiments.exp_tokenize_ceiling [tok1 tok4 tokst]
[--cls text]``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..decompress.decode import (
    decompress_chunks_words,
    pack_streams,
    prepare_words,
    read_tables,
    row_pairs,
)
from ..decompress.tables import BAD_DATA, CONSTS, K_BASE, K_EOB, K_LIT, \
    K_SUB, LTB, OK, OTB, STAGE_W
from ..device import resolve_device
from . import timing
from .corpus import CHUNK, CORPUS_BYTES, class_streams, make_corpus

CONFIGS = {"tok1": (1, False), "tok2": (2, False), "tok4": (4, False),
           "tok8": (8, False), "tokst": (1, True), "tokst4": (4, True)}
VARIANTS = ("tok1", "tok4", "tokst")
CLASSES = ("text", "skew", "recs", "runs", "mixed")
_LLM = (1 << LTB) - 1
_OFM = (1 << OTB) - 1
_M32 = 0xFFFFFFFF


def reset_launch_counts() -> None:
    tokenize_chunks.launches = 0


def _low_mask(n: int) -> int:
    """XLA's (1 << n) - 1 in int32: all ones for n outside [0, 32)."""
    return (1 << n) - 1 if 0 <= n < 32 else _M32


def _stored(dw, t, bb, op, acc, olen, base_max):
    """A stored block as one token (``do_stored``).  Returns (t, bb, op,
    acc, status)."""
    t2 = (t + 7) & ~7
    if (t2 >> 5) + 1 - bb >= STAGE_W:
        bb = (min(t2 >> 5, base_max) >> 10) << 10
    v = dw[t2 >> 5] >> (t2 & 31)
    ln = v & 0xFFFF
    bad = (ln ^ 0xFFFF) != (v >> 16) & 0xFFFF or op + ln > olen
    return (t2 + 32 + (ln << 3), bb, op if bad else op + ln, acc ^ ln,
            BAD_DATA if bad else OK)


def _huffman(dw, t, bb, btype, op, acc, olen, guard, base_max, chain):
    """A static or dynamic block (``do_huffman``): table setup, then the
    group loop of a literal burst and one item.  Adds the block's tokens
    and litlen/offset table lookups to chain[0] and chain[1].  Returns (t,
    bb, op, acc, status)."""
    ll, of, t, bb, ok = read_tables(dw, t, bb, btype, base_max)
    if not ok:
        return t, bb, op, acc, BAD_DATA
    while True:
        tw = t >> 5
        if tw + 3 - bb >= STAGE_W:
            bb = (min(tw, base_max) >> 10) << 10
        # past the guard the iteration still runs, then the loop stops
        stt = BAD_DATA if tw > guard else OK
        bits_left = ((bb + STAGE_W - 1) << 5) - t
        niter = n0 = min(max(bits_left - 64, 0) >> 4, max(olen - op, 0) >> 1)
        w = dw[tw] >> (t & 31)
        e = ll[w & _LLM]
        while niter and not e & 0x3000:               # kind == K_LIT
            acc ^= e
            op += 1 + ((e >> 14) & 1)
            t += e & 0xFF
            w = dw[t >> 5] >> (t & 31)
            e = ll[w & _LLM]
            niter -= 1

        w &= _M32
        kind = (e >> 12) & 3
        looks = 2 + n0 - niter
        if kind == K_SUB:
            e = ll[(e >> 16) + ((w >> LTB) & _low_mask((e >> 8) & 15))]
            kind = (e >> 12) & 3
            looks += 1
        consume = e & 0xFF
        t4 = t + consume
        # the offset lookup runs after every item
        oe = of[(w >> consume) & _OFM]
        w2 = (dw[t4 >> 5] >> (t4 & 31)) & _M32
        if (oe >> 12) & 3 == K_SUB:
            oe = of[(oe >> 16) + ((w2 >> OTB) & _low_mask((oe >> 8) & 15))]
            looks += 1
        chain[0] += 1 + n0 - niter
        chain[1] += looks
        ocons = oe & 0xFF
        ocl = (oe >> 8) & 15
        dist = (oe >> 16) + ((w2 >> ocl) & _low_mask(ocons - ocl))
        if kind == K_LIT:
            t = t4
            ln = 1 + ((e >> 14) & 1)
            bad = op + ln > olen
        elif kind == K_BASE:
            t = t4 + ocons
            cl = (e >> 8) & 15
            ln = (e >> 16) + ((w >> cl) & _low_mask(consume - cl))
            bad = (oe >> 12) & 3 != K_BASE or dist > op or op + ln > olen
        elif kind == K_EOB and e >> 16 == 0:
            return t4, bb, op, acc ^ dist, stt
        else:                           # invalid codeword / stray pointer
            t, bad = t4, True
        if bad:
            return t, bb, op, acc ^ dist, BAD_DATA
        acc ^= (ln << 16) ^ dist
        op += ln
        if stt != OK:
            return t, bb, op, acc, stt


def _tokenize_row(words: np.ndarray, W_pad: int, clen: int, olen: int,
                  chain=None):
    """Tokenize one chunk: words uint32[W] -> (status, op, acc).  chain, a
    list [tokens, lookups], gets the chunk's tokens and litlen/offset table
    lookups added."""
    chain = [0, 0] if chain is None else chain
    in_words = (clen + 3) >> 2
    if clen < 0 or in_words + STAGE_W > words.shape[0]:
        return BAD_DATA, 0, 0
    dw, _ = row_pairs(words, W_pad)
    base_max = W_pad - STAGE_W
    guard = in_words + STAGE_W
    t = bb = op = acc = 0
    status = OK
    while True:
        if t >> 5 >= W_pad:
            status = BAD_DATA
            break
        if (t >> 5) + 1 - bb >= STAGE_W:
            bb = (min(t >> 5, base_max) >> 10) << 10
        hdr = dw[t >> 5] >> (t & 31)
        t += 3
        btype = (hdr >> 1) & 3
        if btype == 0:
            t, bb, op, acc, stat = _stored(dw, t, bb, op, acc, olen,
                                           base_max)
            chain[0] += 1
        elif btype == 3:
            stat = BAD_DATA
        else:
            t, bb, op, acc, stat = _huffman(dw, t, bb, btype, op, acc, olen,
                                            guard, base_max, chain)
        if stat != OK:
            status = stat
            break
        if hdr & 1:
            break
    return status, op, acc & _M32


def tokenize_chunks_plain(comp_words, comp_len, out_len):
    """Plain version of K4 on CPU tensors: a sequential port of
    ``_tok_kernel`` in Python integers, chunk by chunk, in the manner of
    ``decode.decode_chunks_plain``.  Every (unroll, store_tokens) gives
    these outputs.  Same arguments and results as ``tokenize_chunks``."""
    B, W = comp_words.shape
    W_pad = -(-W // 1024) * 1024
    words = comp_words.contiguous().view(torch.int32).numpy().view(np.uint32)
    clen = comp_len.tolist()
    olen = out_len.tolist()
    res = np.zeros((3, B), np.uint32)
    for k in range(B):
        st, op, acc = _tokenize_row(words[k], W_pad, clen[k], olen[k])
        res[:, k] = (st, op & _M32, acc)
    return tuple(torch.from_numpy(res.view(np.int32)))


def chain_counts(comp_words, comp_len, out_len) -> np.ndarray:
    """int64 [2, B]: per chunk the tokens (burst literals, items, stored
    blocks) and the litlen and offset table lookups (subtable probes
    included; the precode lookups of the table setups not) of K4's token
    chain, counted by its plain version.  Each lookup waits for the one
    before it, so lookups times one shared-memory load latency is the
    floor of any one-thread-per-chunk chain."""
    words, comp_len, out_len = prepare_words(comp_words, comp_len, out_len,
                                             torch.device("cpu"))
    B, W = words.shape
    W_pad = -(-W // 1024) * 1024
    rows = words.numpy().view(np.uint32)
    res = np.zeros((2, B), np.int64)
    for k, (clen, olen) in enumerate(zip(comp_len.tolist(),
                                         out_len.tolist())):
        chain = [0, 0]
        _tokenize_row(rows[k], W_pad, clen, olen, chain)
        res[:, k] = chain
    return res


def tokenize_chunks(comp_words, comp_len, out_len, unroll: int = 1,
                    store_tokens: bool = False, device=None):
    """Tokenize B raw-DEFLATE chunks without writing output (K4).

    comp_words: int32/uint32 [B, W] little-endian words of each stream,
      zero-padded by at least STAGE_W words beyond the data.
    comp_len: [B] compressed byte counts; out_len: [B] expected output
      byte counts.
    (unroll, store_tokens): one of the six configurations of ``CONFIGS``.

    Runs on CUDA unless ``device`` names another device: the CUDA kernel
    for CUDA tensors, ``tokenize_chunks_plain`` for CPU tensors.  Returns
    (status, op, acc), int32 [B] each: status 0 OK or 1 BAD_DATA, the
    output length the tokens imply, the tokens' XOR digest."""
    if (unroll, bool(store_tokens)) not in CONFIGS.values():
        raise ValueError(f"(unroll, store_tokens) must be one of "
                         f"{sorted(set(CONFIGS.values()))}, got "
                         f"{(unroll, store_tokens)}")
    dev = resolve_device(device)
    words, comp_len, out_len = prepare_words(comp_words, comp_len, out_len,
                                             dev)
    if dev.type == "cpu":
        return tokenize_chunks_plain(words, comp_len, out_len)
    if dev.type != "cuda":
        raise ValueError(f"tokenize_chunks runs on CUDA or the CPU, not "
                         f"{dev}")
    res = _launch(words, comp_len, out_len, unroll, store_tokens, None)
    _build.count_launch(tokenize_chunks)
    return res[0], res[1], res[2]


def _launch(words, comp_len, out_len, unroll, store_tokens, cycles):
    """Launch K4 on prepared CUDA tensors; cycles, int64 [B, 2] or None,
    receives each chunk's clock64() cycles in all and in its table
    setups.  Returns the int32 [3, B] results."""
    B, W = words.shape
    dev = words.device
    consts = torch.as_tensor(CONSTS, device=dev)
    res = torch.empty(3, B, dtype=torch.int32, device=dev)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("tokenize_chunks", "tokenize_chunks_launch",
                       [P, I, I, I, P, P, P, I, I, P, P, P, P, P])
    p = ctypes.c_void_p
    tensors = (words, comp_len, out_len, consts, res) + (
        () if cycles is None else (cycles,))
    with _build.launch_context(tensors, "tokenize_chunks") as stream:
        err = fn(p(words.data_ptr()), B, W, -(-W // 1024) * 1024,
                 p(comp_len.data_ptr()), p(out_len.data_ptr()),
                 p(consts.data_ptr()), unroll, int(bool(store_tokens)),
                 p(res[0].data_ptr()), p(res[1].data_ptr()),
                 p(res[2].data_ptr()),
                 p(None if cycles is None else cycles.data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"tokenize_chunks kernel failed to launch: CUDA "
                           f"error {err}")
    return res


def phase_cycles(comp_words, comp_len, out_len, unroll: int = 1,
                 store_tokens: bool = False) -> torch.Tensor:
    """int64 [B, 2]: K4's clock64() cycles per chunk on the card, in all
    and in the table setups (the rest is the token loop), from one launch
    that is not counted in ``tokenize_chunks.launches``."""
    dev = resolve_device(None)
    words, comp_len, out_len = prepare_words(comp_words, comp_len, out_len,
                                             dev)
    cycles = torch.zeros(words.shape[0], 2, dtype=torch.int64, device=dev)
    _launch(words, comp_len, out_len, unroll, store_tokens, cycles)
    return cycles


def shared_load_latency(steps: int = 1 << 16) -> dict:
    """The card's latency of one shared-memory load that waits for the one
    before it: {"cycles", "ns"} per load, from ``steps`` loads of a
    pointer chase on one thread (clock64() and %globaltimer)."""
    dev = resolve_device(None)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    fn = _build.kernel("tokenize_chunks", "shared_chase_launch",
                       [_build.INT, _build.PTR, _build.PTR])
    with _build.launch_context((out,), "shared_chase") as stream:
        err = fn(steps, ctypes.c_void_p(out.data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"shared_chase kernel failed to launch: CUDA "
                           f"error {err}")
    cyc, ns, _ = out.tolist()
    return {"cycles": cyc / steps, "ns": ns / steps}


def sass_store_counts() -> dict[str, int]:
    """Shared-memory stores (STS) in the built K4 per variant, from
    ``cuobjdump -sass`` of ``build/kernels/libtokenize_chunks.so``: the
    store variants must keep their token stores."""
    _build.load("tokenize_chunks")
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.lib_path("tokenize_chunks"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    names = {cfg: name for name, cfg in CONFIGS.items()}
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*tokenize_chunks_kernel\S*?ILi(\d+)ELb"
                      r"([01])E", line)
        if m:
            cur = names[(int(m.group(1)), m.group(2) == "1")]
            counts[cur] = 0
        elif "Function :" in line:
            cur = None
        elif cur and re.search(r"\bSTS(\.\S+)?\s", line):
            counts[cur] += 1
    return counts


def ceiling_table(classes=CLASSES, variants=VARIANTS, device=None,
                  total: int = CORPUS_BYTES, chunk: int = CHUNK,
                  corpus: bytes | None = None) -> dict:
    """{class: {variant or "dec": {"mb_s", "s", "ok", "bytes"}}}: MB/s of
    output of each K4 variant and of K3's full decode
    (``decompress_chunks_words``) on one class's zlib-6 chunks, one call of
    all its chunks, the median of 3 host-clock passes after a warm-up (the
    script's timing).  ok: every chunk's status is 0 and its op equals its
    length (K4), or it decodes to the chunk (K3)."""
    dev = resolve_device(device)
    corpus = make_corpus(total) if corpus is None else corpus
    table = {}
    for cls in classes:
        chunks, streams = class_streams(cls, total, chunk, corpus)
        comp, clen = pack_streams(streams)
        olen = np.array([len(c) for c in chunks], np.int32)
        cw = torch.as_tensor(comp.view(np.int32), device=dev)
        cl = torch.as_tensor(clen, device=dev)
        ol = torch.as_tensor(olen, device=dev)
        nbytes = int(olen.sum())
        row = {}
        for name in variants:
            u, st = CONFIGS[name]
            status, op, _ = tokenize_chunks(cw, cl, ol, u, st, device=dev)
            ok = bool((status == 0).all()) and bool((op == ol).all())
            dt = timing.median_of(lambda: tokenize_chunks(
                cw, cl, ol, u, st, device=dev), dev)
            row[name] = {"mb_s": nbytes / dt / 1e6, "s": dt, "ok": ok,
                         "bytes": nbytes}
        out_bytes = -(-int(olen.max()) // 4) * 4
        out, status, _, _ = decompress_chunks_words(cw, cl, ol, out_bytes,
                                                    device=dev)
        out = out.cpu().numpy()
        ok = bool((status == 0).all()) and all(
            out[k, :len(c)].tobytes() == c for k, c in enumerate(chunks))
        dt = timing.median_of(lambda: decompress_chunks_words(
            cw, cl, ol, out_bytes, device=dev), dev)
        row["dec"] = {"mb_s": nbytes / dt / 1e6, "s": dt, "ok": ok,
                      "bytes": nbytes}
        table[cls] = row
    return table


def format_table(table: dict) -> list[str]:
    """The script's lines: one per class, MB/s per variant, then K3's."""
    lines = []
    for cls, row in table.items():
        parts = [f"{cls:5s} ({next(iter(row.values()))['bytes']} bytes)"]
        for name, r in row.items():
            label = "K3 dec" if name == "dec" else name
            parts.append(f"{label}={r['mb_s']:.6f} MB/s"
                         f"{'' if r['ok'] else ' MISMATCH'}")
        lines.append("  ".join(parts))
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("--")
             and a in CONFIGS] or list(VARIANTS)
    classes = ([argv[argv.index("--cls") + 1]] if "--cls" in argv
               else list(CLASSES))
    dev = resolve_device("cpu" if "--cpu" in argv else None)
    print(f"device: {timing.describe(dev)}", flush=True)
    table = ceiling_table(classes, names, device=dev)
    for line in format_table(table):
        print(line, flush=True)
    return 0 if all(r["ok"] for row in table.values()
                    for r in row.values()) else 1


reset_launch_counts()

if __name__ == "__main__":
    sys.exit(main())
