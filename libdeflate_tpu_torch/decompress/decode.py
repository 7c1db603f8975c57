"""The scalar DEFLATE decoder (K3): entry points, wrapper, plain version.

Counterpart of ``libdeflate_tpu/decompress/pallas_decode.py``:

- ``decompress_chunks_words`` is ``decompress_chunks_pallas`` (lines
  941-1020): padded compressed words [B, W] -> (out, status, out_lens,
  consumed).  For CUDA tensors it launches ``csrc/decode_chunks.cu``, which
  replaces the Pallas kernel ``_decode_kernel`` (363-938); for CPU tensors
  it runs ``decode_chunks_plain``.  Launches are counted in its
  ``launches`` attribute.
- ``decompress_chunks_host`` is ``decompress_chunks_pallas_host``
  (1023-1043) and ``decompress_chunks`` the unknown-size entry of the mesh
  path (1046-1059), with the reference's exact padding.

The observable result is all four outputs for every input, so the plain
version and the kernel keep ``_decode_kernel``'s control flow and bounds,
including the bookkeeping of its input staging window: the window base
moves only when ``(t >> 5) + margin - base >= STAGE_W``, to
``min(t >> 5, W_pad - STAGE_W)`` rounded down to 1024 words, and it sets
the literal-burst budget, the stored-copy bound and so where a damaged
stream stops.  The kernel keeps the reference's 64 KiB output ring in
shared memory, flushed to ``out`` each time the output crosses a 32 KiB
boundary; unlike the reference it also flushes the rest on a failure, so
``out`` holds every decoded byte below a chunk's ``out_len`` on a failure
too, and bytes at and past ``out_len`` are zeros (the reference leaves
stale ring words there).  ``chain_counts`` counts the plain version's
table lookups, the floor of the kernel's dependent chain.

Where the reference's behaviour is undefined the port chooses, and both
versions agree:
- a chunk whose ``comp_len`` is negative or leaves fewer than ``STAGE_W``
  words of its row as padding (the reference's input contract) is
  BAD_DATA with out_len 0 and consumed 0, without decoding;
- a word read past the padded row reads word ``W_pad - 1``, as the
  reference's staging index clamps in interpret mode, and a block header
  there is BAD_DATA;
- bytes past ``out_bytes`` are dropped (the reference writes them into its
  output slack), while ``out_len`` and status follow ``out_len`` as there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..device import as_tensor, resolve_device
from ..utils.profiling import span
from .tables import (
    BAD_DATA,
    FLUSHB,
    K_BASE,
    K_EOB,
    K_LIT,
    K_SUB,
    LTB,
    OK,
    OTB,
    PRECODE_PERM,
    STAGE_W,
    STATIC_LENS,
    CONSTS,
    build_table,
)

MAX_W = 1 << 25            # row words; keeps every bit cursor below 2**31
_PERM = PRECODE_PERM.tolist()
_LLM = (1 << LTB) - 1
_OFM = (1 << OTB) - 1


def reset_launch_counts() -> None:
    decompress_chunks_words.launches = 0


_STATIC_LL, _ = build_table(STATIC_LENS[:288], 1)
_STATIC_OF, _ = build_table(STATIC_LENS[288:], 2)


def _stored(dw, rowb, out, t, bb, olen, base_max):
    """One stored block (``do_stored``) from the bit after its header.
    Returns (t, bb, status)."""
    t2 = (t + 7) & ~7
    if (t2 >> 5) + 1 - bb >= STAGE_W:
        bb = (min(t2 >> 5, base_max) >> 10) << 10
    v = dw[t2 >> 5] >> (t2 & 31)
    ln = v & 0xFFFF
    ib = (t2 + 32) >> 3
    if (ln ^ 0xFFFF) != (v >> 16) & 0xFFFF or len(out) + ln > olen:
        return ib << 3, bb, BAD_DATA
    rem = ln
    while rem > 0:
        # copy chunks bounded by the staged window, the next 32 KiB output
        # boundary and what is left; BAD once the window is used up
        if (ib >> 2) + 3 - bb >= STAGE_W:
            bb = (min(ib >> 2, base_max) >> 10) << 10
        stage_left = 4 * (bb + STAGE_W) - ib - 8
        if stage_left <= 0:
            return ib << 3, bb, BAD_DATA
        room = min(stage_left, FLUSHB - (len(out) & (FLUSHB - 1)), rem)
        out += rowb[ib:ib + room]
        ib += room
        rem -= room
    return ib << 3, bb, OK


def read_tables(dw, t, bb, btype, base_max):
    """The table setup of a static or dynamic block (``do_huffman``'s
    first half) from the bit after its header, over the row ``dw`` of
    ``row_pairs``.  Returns (ll, of, t, bb, ok); the tables are None when
    the code lengths are bad."""
    if btype == 1:
        return _STATIC_LL, _STATIC_OF, t, bb, True
    if (t >> 5) + 1 - bb >= STAGE_W:
        bb = (min(t >> 5, base_max) >> 10) << 10
    v = dw[t >> 5] >> (t & 31)
    num_ll = 257 + (v & 31)
    num_of = 1 + ((v >> 5) & 31)
    num_pre = 4 + ((v >> 10) & 15)
    t += 14
    plens = [0] * 19
    for i in range(num_pre):
        if (t >> 5) + 1 - bb >= STAGE_W:
            bb = (min(t >> 5, base_max) >> 10) << 10
        plens[_PERM[i]] = (dw[t >> 5] >> (t & 31)) & 7
        t += 3
    pre, ok = build_table(plens, 0)
    # RLE-decode the litlen + offset lengths
    total = num_ll + num_of
    lens = [0] * total
    i = 0
    while ok and i < total:
        if (t >> 5) + 1 - bb >= STAGE_W:
            bb = (min(t >> 5, base_max) >> 10) << 10
        e = pre[(dw[t >> 5] >> (t & 31)) & 127]
        sym = e >> 16
        t += e & 0xFF
        if (t >> 5) + 1 - bb >= STAGE_W:
            bb = (min(t >> 5, base_max) >> 10) << 10
        w2 = dw[t >> 5] >> (t & 31)
        if sym < 16:
            lens[i] = sym
            i += 1
            continue
        if sym == 16:
            rep, ebits, val = 3 + (w2 & 3), 2, lens[i - 1] if i else 0
        elif sym == 17:
            rep, ebits, val = 3 + (w2 & 7), 3, 0
        else:
            rep, ebits, val = 11 + (w2 & 127), 7, 0
        if (sym == 16 and i == 0) or i + rep > total:
            ok = False
        else:
            lens[i:i + rep] = [val] * rep
        i += rep
        t += ebits
    if not ok:
        return None, None, t, bb, False
    ll, ok_l = build_table(lens[:num_ll], 1)
    of, ok_o = build_table(lens[num_ll:], 2)
    if not (ok_l and ok_o):
        return None, None, t, bb, False
    return ll, of, t, bb, True


def _huffman(dw, out, t, bb, btype, olen, guard, base_max, chain=None):
    """One static or dynamic block (``do_huffman``) from the bit after its
    header: table setup, then the group loop.  chain, a list [tokens,
    lookups] or None, gets the block's tokens and litlen/offset table
    lookups added.  Returns (t, bb, status)."""
    ll, of, t, bb, ok = read_tables(dw, t, bb, btype, base_max)
    if not ok:
        return t, bb, BAD_DATA

    # group loop: a literal burst within the staged window and >= 8 bytes
    # clear of the next 32 KiB boundary and of out_len, then one item
    append = out.append
    while True:
        tw = t >> 5
        if tw + 3 - bb >= STAGE_W:
            bb = (min(tw, base_max) >> 10) << 10
        # past the guard the iteration still runs, then the loop stops
        stt = BAD_DATA if tw > guard else OK
        op = len(out)
        bits_left = ((bb + STAGE_W - 1) << 5) - t
        room = min(FLUSHB - (op & (FLUSHB - 1)), olen - op)
        niter = n0 = min(max(bits_left - 64, 0) >> 4,
                         max(room - 8, 0) >> 1)
        w = dw[tw] >> (t & 31)
        e = ll[w & _LLM]
        while niter and not e & 0x3000:               # kind == K_LIT
            p = e >> 16
            if e & 0x4000:
                append(p & 0xFF)
                append(p >> 8)
            else:
                append(p)
            t += e & 0xFF
            w = dw[t >> 5] >> (t & 31)
            e = ll[w & _LLM]
            niter -= 1

        kind = (e >> 12) & 3
        if chain is not None:
            chain[0] += 1 + n0 - niter
            chain[1] += 1 + n0 - niter + (kind == K_SUB)
        if kind == K_SUB:
            e = ll[(e >> 16) + ((w >> LTB) & ((1 << ((e >> 8) & 15)) - 1))]
            kind = (e >> 12) & 3
        consume = e & 0xFF
        t4 = t + consume
        op = len(out)
        if kind == K_LIT:
            t = t4
            p = e >> 16
            if e & 0x4000:
                if op + 2 > olen:
                    return t, bb, BAD_DATA
                append(p & 0xFF)
                append(p >> 8)
            else:
                if op + 1 > olen:
                    return t, bb, BAD_DATA
                append(p)
        elif kind == K_BASE:
            cl = (e >> 8) & 15
            length = (e >> 16) + ((w >> cl) & ((1 << (consume - cl)) - 1))
            oe = of[(w >> consume) & _OFM]
            w2 = dw[t4 >> 5] >> (t4 & 31)
            if chain is not None:
                chain[1] += 1 + ((oe >> 12) & 3 == K_SUB)
            if (oe >> 12) & 3 == K_SUB:
                oe = of[(oe >> 16)
                        + ((w2 >> OTB) & ((1 << ((oe >> 8) & 15)) - 1))]
            ocons = oe & 0xFF
            ocl = (oe >> 8) & 15
            dist = (oe >> 16) + ((w2 >> ocl) & ((1 << (ocons - ocl)) - 1))
            t = t4 + ocons
            if (oe >> 12) & 3 != K_BASE or dist > op or op + length > olen:
                return t, bb, BAD_DATA
            s = op - dist
            if dist >= length:
                out += out[s:s + length]
            else:                       # overlapping: the period repeats
                out += (out[s:op] * (length // dist + 1))[:length]
        elif kind == K_EOB and e >> 16 == 0:
            return t4, bb, stt
        else:                           # invalid codeword / stray pointer
            return t4, bb, BAD_DATA
        if stt != OK:
            return t, bb, stt


def row_pairs(words: np.ndarray, W_pad: int):
    """One row of uint32 words as (dw, rowb): the 64-bit pairs dw[i] =
    word i | word i+1 << 32, zero-padded to W_pad words, then word
    W_pad - 1 repeated for reads past the row (a damaged stream's header
    and RLE reads reach ~150 words past); rowb the padded row's bytes."""
    wp = np.zeros(W_pad + 258, np.uint64)
    wp[:words.shape[0]] = words
    wp[W_pad:] = wp[W_pad - 1]
    dw = (wp[:-1] | (wp[1:] << np.uint64(32))).tolist()
    return dw, wp[:W_pad].astype("<u4").tobytes()


def _decode_row(words: np.ndarray, W_pad: int, clen: int, olen: int,
                strict: bool, chain=None):
    """Decode one chunk: words uint32[W] -> (bytearray, status, out_len,
    consumed).  chain, a list [tokens, lookups] or None, gets the chunk's
    tokens and litlen/offset table lookups added."""
    in_words = (clen + 3) >> 2
    if clen < 0 or in_words + STAGE_W > words.shape[0]:
        return bytearray(), BAD_DATA, 0, 0
    dw, rowb = row_pairs(words, W_pad)
    base_max = W_pad - STAGE_W
    guard = in_words + STAGE_W

    out = bytearray()
    t = bb = 0
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
            t, bb, stat = _stored(dw, rowb, out, t, bb, olen, base_max)
            if chain is not None:
                chain[0] += 1
        elif btype == 3:
            stat = BAD_DATA
        else:
            t, bb, stat = _huffman(dw, out, t, bb, btype, olen, guard,
                                   base_max, chain)
        if stat != OK:
            status = stat
            break
        if hdr & 1:
            break
    op = len(out)
    if status == OK and strict and op != olen:
        status = BAD_DATA
    return out, status, op, min((t + 7) >> 3, clen)


def decode_chunks_plain(comp_words, comp_len, out_len, out_bytes: int,
                        known_size: bool = True):
    """Plain version of K3 on CPU tensors: a sequential port of
    ``_decode_kernel`` in Python integers, run chunk by chunk over a host
    copy of each row.  It is not a per-symbol loop of torch ops, which
    would take minutes at test sizes; this takes seconds per MiB.
    Same arguments and results as ``decompress_chunks_words``."""
    B, W = comp_words.shape
    W_pad = -(-W // 1024) * 1024
    words = comp_words.contiguous().view(torch.int32).numpy().view(np.uint32)
    clen = comp_len.tolist()
    olen = out_len.tolist()
    out = np.zeros((B, out_bytes), np.uint8)
    res = np.zeros((3, B), np.int32)
    for k in range(B):
        buf, st, op, cons = _decode_row(words[k], W_pad, clen[k], olen[k],
                                        known_size)
        n = min(op, out_bytes)
        out[k, :n] = np.frombuffer(bytes(buf[:n]), np.uint8)
        res[:, k] = (st, op, cons)
    status, out_lens, consumed = torch.from_numpy(res)
    return torch.from_numpy(out), status, out_lens, consumed


def chain_counts(comp_words, comp_len, out_len) -> np.ndarray:
    """int64 [2, B]: per chunk the tokens (burst literals, items, stored
    blocks) and the litlen and offset table lookups (subtable probes
    included; the precode lookups of the table setups not) of K3's token
    loop, counted by its plain version: K3's burst budget, which stops 8
    bytes short of each 32 KiB boundary, and an offset lookup for each
    match only.  Each lookup waits for the one before it, so the lookups
    of the chunk with the most tokens times one shared-memory load latency
    is the floor of a decode that runs each chunk's chain on one thread or
    one warp."""
    words, comp_len, out_len = prepare_words(comp_words, comp_len, out_len,
                                             torch.device("cpu"))
    B, W = words.shape
    W_pad = -(-W // 1024) * 1024
    rows = words.numpy().view(np.uint32)
    res = np.zeros((2, B), np.int64)
    for k, (clen, olen) in enumerate(zip(comp_len.tolist(),
                                         out_len.tolist())):
        chain = [0, 0]
        _decode_row(rows[k], W_pad, clen, olen, True, chain)
        res[:, k] = chain
    return res


def prepare_words(comp_words, comp_len, out_len, dev: torch.device):
    """Check the padded-words inputs of K3 and K4 and move them to dev:
    returns (words int32 [B, W], comp_len int32 [B], out_len int32 [B])."""
    if isinstance(comp_words, np.ndarray):
        comp_words = torch.from_numpy(np.ascontiguousarray(comp_words))
    if comp_words.dtype not in (torch.int32, torch.uint32) \
            or comp_words.dim() != 2:
        raise ValueError(f"comp_words must be int32/uint32 [B, W], got "
                         f"{comp_words.dtype} {tuple(comp_words.shape)}")
    B, W = comp_words.shape
    if not STAGE_W <= W <= MAX_W:
        raise ValueError(f"comp_words rows must hold {STAGE_W} to {MAX_W} "
                         f"words (the stream plus STAGE_W words of zero "
                         f"padding), got {W}")
    if not comp_words.is_contiguous():
        raise ValueError("comp_words must be contiguous")
    comp_len = as_tensor(comp_len, np.int32)
    out_len = as_tensor(out_len, np.int32)
    if comp_len.shape != (B,) or out_len.shape != (B,):
        raise ValueError("comp_len and out_len must have shape [B]")
    return (comp_words.view(torch.int32).to(dev),
            comp_len.to(dev, torch.int32).contiguous(),
            out_len.to(dev, torch.int32).contiguous())


def decompress_chunks_words(comp_words, comp_len, out_len, out_bytes: int,
                            known_size: bool = True, device=None):
    """Decode B raw-DEFLATE chunks (``decompress_chunks_pallas``).

    comp_words: int32/uint32 [B, W] little-endian words of each compressed
      stream, zero-padded by at least STAGE_W words beyond the data.
    comp_len: [B] compressed byte counts.
    out_len: [B] expected output byte counts (known-size mode) or each
      chunk's capacity (unknown-size mode).
    out_bytes: per-chunk output width, a multiple of 4.
    known_size: if True, an output length other than out_len is BAD_DATA;
      if False, decoding stops at BFINAL and the length is reported.

    Runs on CUDA unless ``device`` names another device: the CUDA kernel
    for CUDA tensors, ``decode_chunks_plain`` for CPU tensors.  Returns
    (out uint8[B, out_bytes], status int32[B], out_lens int32[B],
    consumed int32[B]); out is zero at and past each out_len."""
    dev = resolve_device(device)
    if out_bytes <= 0 or out_bytes % 4:
        raise ValueError(f"out_bytes must be a positive multiple of 4, got "
                         f"{out_bytes}")
    words, comp_len, out_len = prepare_words(comp_words, comp_len, out_len,
                                             dev)
    B, W = words.shape
    if dev.type == "cpu":
        return decode_chunks_plain(words, comp_len, out_len, out_bytes,
                                   known_size)
    if dev.type != "cuda":
        raise ValueError(f"decompress_chunks_words runs on CUDA or the CPU, "
                         f"not {dev}")
    consts = torch.as_tensor(CONSTS, device=dev)
    out = torch.zeros(B, out_bytes, dtype=torch.uint8, device=dev)
    res = torch.empty(3, B, dtype=torch.int32, device=dev)
    W_pad = -(-W // 1024) * 1024
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("decode_chunks", "decode_chunks_launch",
                       [P, I, I, I, P, P, I, P, P, I, P, P, P, P])
    p = ctypes.c_void_p
    with _build.launch_context((words, comp_len, out_len, consts, out, res),
                               "decode_chunks") as stream:
        err = fn(p(words.data_ptr()), B, W, W_pad, p(comp_len.data_ptr()),
                 p(out_len.data_ptr()), int(known_size),
                 p(consts.data_ptr()), p(out.data_ptr()), out_bytes,
                 p(res[0].data_ptr()), p(res[1].data_ptr()),
                 p(res[2].data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"decode_chunks kernel failed to launch: CUDA "
                           f"error {err}")
    _build.count_launch(decompress_chunks_words)
    return out, res[0], res[1], res[2]


def pack_streams(streams, pad_words: int = 2 * STAGE_W):
    """list[bytes] -> (uint32 [B, longest + pad_words] little-endian words,
    zero-padded; int32 [B] byte counts)."""
    comp = np.zeros((len(streams),
                     max(-(-len(s) // 4) for s in streams) + pad_words),
                    np.uint32)
    for k, s in enumerate(streams):
        comp[k, : -(-len(s) // 4)] = np.frombuffer(
            s + b"\0" * (-len(s) % 4), np.uint32)
    return comp, np.array([len(s) for s in streams], np.int32)


def decompress_chunks_host(streams, out_lens, device=None):
    """list[bytes] streams, list[int] expected sizes -> (list[bytes],
    list[int] statuses) (``decompress_chunks_pallas_host``): words padded by
    2 * STAGE_W past the longest stream, known-size mode."""
    B = len(streams)
    out_cap = max(max(out_lens), 4)
    out_cap = -(-out_cap // 4) * 4
    comp, clen = pack_streams(streams)
    out, status, _, _ = decompress_chunks_words(
        comp, clen, np.asarray(out_lens, np.int32), out_cap, device=device)
    out = out.cpu().numpy()
    return ([bytes(out[k, : out_lens[k]]) for k in range(B)],
            [int(s) for s in status.tolist()])


def decompress_chunks(bufs, in_lens, out_cap: int, device=None):
    """Unknown-size entry of the mesh path (``pallas_decode.
    decompress_chunks``): uint8[B, N], int32[B] -> (uint8[B, out_cap],
    out_lens, consumed, status).  The bytes are padded to N rounded up to 4
    plus 8 * STAGE_W on the device, then read as words.  With a profiler
    session on, the padding is the range ``decode.prepare`` and the
    decoder's call ``decode.kernel``."""
    dev = resolve_device(device)
    with span("decode.prepare"):
        bufs = as_tensor(bufs, np.uint8).to(dev)
        if bufs.dtype != torch.uint8 or bufs.dim() != 2:
            raise ValueError(f"bufs must be uint8[B, N], got {bufs.dtype} "
                             f"{tuple(bufs.shape)}")
        B, N = bufs.shape
        padded = -(-N // 4) * 4 + 8 * STAGE_W
        b8 = torch.zeros(B, padded, dtype=torch.uint8, device=dev)
        b8[:, :N] = bufs
        cap4 = -(-out_cap // 4) * 4
    with span("decode.kernel"):
        out, status, oplens, consumed = decompress_chunks_words(
            b8.view(torch.int32), in_lens,
            torch.full((B,), cap4, dtype=torch.int32), cap4,
            known_size=False, device=dev)
    return out[:, :out_cap], oplens, consumed, status


reset_launch_counts()
