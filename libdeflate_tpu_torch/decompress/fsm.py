"""The FSM decoder (F1): entry points, wrapper, plain version.

Counterpart of ``libdeflate_tpu/decompress/tpu.py``, the whole-buffer
decoder that the JAX package compiles from nested ``lax.while_loop``s (an
outer loop a block, an inner loop a symbol) and runs on every backend
but the TPU.  The mesh's ``decoder="fsm"`` names it.

- ``decompress_chunks`` is ``decompress_chunks`` (``tpu.py:433``): raw
  DEFLATE streams uint8[B, N] with int32[B] byte counts ->
  (out uint8[B, out_cap], out_lens, consumed, result).  For CUDA tensors
  it launches ``csrc/fsm_decode.cu``, a kernel written for this decoder
  (the JAX package has no Pallas kernel here: XLA compiles
  ``deflate_decompress_chunk``, ``tpu.py:168``); for CPU tensors it runs
  ``decode_chunks_fsm_plain``.  Launches are counted in its ``launches``
  attribute.
- ``deflate_decompress_chunk`` is the single-stream function of the same
  name (``tpu.py:168``), a batch of one.
- ``_canon_host`` and ``_canon_tables`` are ``tpu.py:59`` and ``:87``:
  the count-based canonical tables (``count``, ``first_code``,
  ``first_idx`` and the symbols sorted by (length, symbol), unused ones
  last), with the zlib-lax incomplete codes patched to a complete 1-bit
  code.
- ``root_table``, ``pair_literals``, ``first_of`` and ``root_lookup``
  mirror the kernel's root tables for the tests
  (``tests/test_torch_fsm_table.py``): F1 decodes a symbol by one load
  from a table over its first R bits (``ROOT_BITS``: 11 litlen, 10
  offsets, 7 precode) built from those canonical tables, pairs two short
  literals in one litlen entry, and takes ``_decode_sym``'s 15-length
  compare only where the shortest matching length exceeds R.

F1 (``csrc/fsm_decode.cu``) runs one warp a stream: the row staged into a
shared-memory ring by ``cp.async`` under a 64-bit bit buffer, the root
tables above, and the output in a 64 KiB shared-memory window flushed to
``out`` a 32 KiB half at a time.  Its launch takes about 113 KiB of
dynamic shared memory a block (``fsm_decode_smem_bytes``).

The observable result is all four outputs, so the plain version and the
kernel keep ``deflate_decompress_chunk``'s control flow step by step:

- bytes at and past ``min(in_nbytes, N)`` read as zero, and a block may
  read up to 49 bits past the input (``hard_limit``); the stream is good
  only if its last block ends at or before ``8 * in_nbytes`` bits;
- a literal is written (and counted in ``out_len``) whenever it fits
  ``out_cap``, even when its codeword ends past ``hard_limit`` and the
  result is BAD_DATA; after a failure the bit cursor is where that step
  left it, and ``consumed = min((bit_pos + 7) >> 3, in_nbytes)``;
- a stored block whose LEN fits the input but not ``out_cap`` is
  INSUFFICIENT_SPACE, a mismatched NLEN or a LEN past the input BAD_DATA;
- the output holds every decoded byte and zeros past ``out_len``.

Where the JAX decoder's int32 arithmetic would wrap (``8 * in_nbytes``
past 2**31) the port does not; N and ``out_cap`` are at most
``MAX_BYTES``, so that every bit cursor stays below 2**31.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..device import as_tensor, resolve_device
from ..formats.deflate import (
    LENGTH_SLOT_BASE,
    LENGTH_SLOT_EXTRA,
    OFFSET_SLOT_BASE,
    OFFSET_SLOT_EXTRA,
    PRECODE_LENS_PERMUTATION,
    STATIC_LITLEN_LENS,
    STATIC_OFFSET_LENS,
)

MAXSYMS = 288  # largest alphabet (litlen); offsets/precode are padded to it
MAX_BYTES = 1 << 26  # N, out_cap: at 15 bits a byte, cursors below 2**31

RES_OK = 0
RES_BAD = 1
RES_INSUFFICIENT = 3

_LEN_BASE = LENGTH_SLOT_BASE.tolist()
_LEN_EXTRA = LENGTH_SLOT_EXTRA.tolist()
_OFF_BASE = OFFSET_SLOT_BASE.tolist()
_OFF_EXTRA = OFFSET_SLOT_EXTRA.tolist()
_PERM = PRECODE_LENS_PERMUTATION.tolist()
# 15-bit reversal: bit i of x at bit 14 - i
_REV15 = [int(f"{x:015b}"[::-1], 2) for x in range(1 << 15)]


def reset_launch_counts() -> None:
    decompress_chunks.launches = 0


# --------------------------------------------------------------------------
# canonical table math
# --------------------------------------------------------------------------
class _Table:
    """One code's canonical decode structures, with a memo of the symbol
    each 15-bit window decodes to."""

    __slots__ = ("count", "first_code", "first_idx", "sorted_syms", "memo")

    def __init__(self, count, first_code, first_idx, sorted_syms):
        self.count = [int(c) for c in count]
        self.first_code = [int(c) for c in first_code]
        self.first_idx = [int(c) for c in first_idx]
        self.sorted_syms = [int(s) for s in sorted_syms]
        self.memo = {}


def _canon_host(lens) -> _Table:
    """(count16, first_code16, first_idx16, sorted_syms[MAXSYMS]) of a
    complete code (``tpu.py:59``)."""
    lens = np.asarray(lens, dtype=np.int32)
    count = np.bincount(lens, minlength=16)[:16]
    count[0] = 0
    first_code = np.zeros(16, np.int32)
    code = 0
    for ln in range(1, 16):
        first_code[ln] = code
        code = (code + count[ln]) << 1
    first_idx = np.zeros(16, np.int32)
    first_idx[1:] = np.cumsum(count)[:15]
    key = np.where(lens > 0, lens, 99) * 1024 + np.arange(len(lens))
    order = np.argsort(key, kind="stable").astype(np.int32)
    syms = np.zeros(MAXSYMS, np.int32)
    syms[: len(order)] = order
    return _Table(count, first_code, first_idx, syms)


_ST_LL = _canon_host(STATIC_LITLEN_LENS)
_ST_OF = _canon_host(STATIC_OFFSET_LENS)


def _canon_tables(lens, nsyms: int):
    """(ok, table) from lens[MAXSYMS] (zeros padded), the symbols at and
    past ``nsyms`` unused (``tpu.py:87``).  An incomplete code is accepted
    only as the empty code or a single 1-bit codeword, patched to a
    complete 1-bit code (count[1] = 2, its two slots the one symbol, or
    symbol 0 for the empty code); anything else incomplete, and anything
    overfull, is not ok."""
    lens = [int(x) if i < nsyms else 0 for i, x in enumerate(lens[:MAXSYMS])]
    lens += [0] * (MAXSYMS - len(lens))
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    codespace = sum(count[ln] << (15 - ln) for ln in range(1, 16))
    full = 1 << 15
    overfull = codespace > full
    single_ok = codespace == full >> 1 and count[1] == 1
    empty_ok = codespace == 0
    incomplete = codespace < full
    bad = overfull or (incomplete and not (single_ok or empty_ok))
    use_patch = incomplete and not bad
    if use_patch:
        patch_sym = 0 if empty_ok else lens.index(1)
        lens = [0] * MAXSYMS
        lens[patch_sym] = 1
        count = [0] * 16
        count[1] = 2
    first_code = [0] * 16
    code = 0
    for ln in range(1, 16):
        first_code[ln] = code
        code = (code + count[ln]) << 1
    first_idx = [0] * 16
    for ln in range(1, 16):
        first_idx[ln] = first_idx[ln - 1] + count[ln - 1]
    sorted_syms = sorted(range(MAXSYMS),
                         key=lambda s: (lens[s] if lens[s] else 99, s))
    if use_patch:
        sorted_syms[1] = sorted_syms[0]
    return not bad, _Table(count, first_code, first_idx, sorted_syms)


def _decode_sym(tab: _Table, bits: int):
    """(sym, codeword length, ok) of the 15-bit window ``bits`` (LSB
    first): the shortest length whose prefix lies in its code range; no
    length does only for a code that was never complete, and then length
    1 and whatever symbol its index reaches (``tpu.py:150``)."""
    hit = tab.memo.get(bits)
    if hit is None:
        rev = _REV15[bits]
        count, fc = tab.count, tab.first_code
        ln, ok = 1, False
        for cand in range(1, 16):
            off = (rev >> (15 - cand)) - fc[cand]
            if 0 <= off < count[cand]:
                ln, ok = cand, True
                break
        off = (rev >> (15 - ln)) - fc[ln]
        idx = min(max(tab.first_idx[ln] + off, 0), MAXSYMS - 1)
        hit = tab.memo[bits] = (tab.sorted_syms[idx], ln, ok)
    return hit


# --------------------------------------------------------------------------
# the kernel's root tables, mirrored for the tests
# --------------------------------------------------------------------------
# F1's root widths (``csrc/fsm_decode.cu`` kLLR, kOFR, kPreR)
ROOT_BITS = {"litlen": 11, "offset": 10, "precode": 7}
PAIR_BIT = 26  # above a length symbol's base (bits 17-25)
_REV15_NP = np.asarray(_REV15, np.int64)


def _entries(role: str, sym: np.ndarray, ln: np.ndarray) -> np.ndarray:
    """The kernel's ``make_entry``: bits 0-3 the length, 4-12 the symbol,
    13-16 the extra bits and 17-31 the base of a length or offset symbol
    (an offset symbol past 29 takes slot 29's)."""
    e = ln.astype(np.int64) | (sym.astype(np.int64) << 4)
    if role == "litlen":
        s = np.clip(sym - 257, 0, 28)
        is_len = (sym >= 257) & (sym <= 285)
        e |= np.where(is_len, (LENGTH_SLOT_EXTRA[s].astype(np.int64) << 13)
                      | (LENGTH_SLOT_BASE[s].astype(np.int64) << 17), 0)
    elif role == "offset":
        s = np.minimum(sym, 29)
        e |= (OFFSET_SLOT_EXTRA[s].astype(np.int64) << 13) \
            | (OFFSET_SLOT_BASE[s].astype(np.int64) << 17)
    return e.astype(np.uint32)


def _shortest(tab: _Table, rev: np.ndarray, width: int, lengths):
    """(length, offset) of the shortest length among ``lengths`` whose
    prefix of the width-bit codes ``rev`` (first bit highest) lies in its
    code range; length 0 where none does."""
    ln = np.zeros(rev.shape, np.int64)
    off = np.zeros(rev.shape, np.int64)
    for cand in sorted(lengths, reverse=True):
        o = (rev >> (width - cand)) - tab.first_code[cand]
        hit = (o >= 0) & (o < tab.count[cand])
        ln = np.where(hit, cand, ln)
        off = np.where(hit, o, off)
    return ln, off


def pair_literals(root: np.ndarray) -> np.ndarray:
    """The kernel's ``pair_literals`` on a litlen root: each literal entry
    whose length l1 is below the root width and whose window's rest (w >>
    l1) holds a literal of length l2 <= R - l1 becomes a pair entry (bits
    0-3 l1 + l2, 4-11 the first literal, 13-16 l1, 17-24 the second, bit
    ``PAIR_BIT``, which no single litlen entry sets)."""
    R = ROOT_BITS["litlen"]
    e1 = root.astype(np.int64)
    l1, s1 = e1 & 15, (e1 >> 4) & 511
    e2 = e1[np.arange(len(e1)) >> l1]
    l2, s2 = e2 & 15, (e2 >> 4) & 511
    pair = (l1 != 0) & (s1 < 256) & (l1 < R) & (l2 != 0) & (s2 < 256) \
        & (l1 + l2 <= R)
    paired = (l1 + l2) | (s1 << 4) | (l1 << 13) | (s2 << 17) | (1 << PAIR_BIT)
    return np.where(pair, paired, e1).astype(np.uint32)


def first_of(e: np.ndarray) -> np.ndarray:
    """The kernel's ``first_of``: a pair entry's first literal as a single
    entry, other entries as they are."""
    e = np.asarray(e, np.int64)
    return np.where((e >> PAIR_BIT) & 1, ((e >> 13) & 15) | (e & 0xFF0),
                    e).astype(np.uint32)


def root_table(tab: _Table, role: str) -> np.ndarray:
    """The kernel's ``build_root`` (and, for litlen, ``pair_literals``)
    for the tests: uint32 [2**R] entries (R = ``ROOT_BITS[role]``), for
    each R-bit window (LSB first) the entry of the shortest length up to R
    whose prefix lies in its code range, 0 where none does."""
    R = ROOT_BITS[role]
    rev = _REV15_NP[:1 << R] >> (15 - R)
    ln, off = _shortest(tab, rev, R, range(1, R + 1))
    idx = np.minimum(np.asarray(tab.first_idx)[ln] + off, MAXSYMS - 1)
    sym = np.asarray(tab.sorted_syms)[idx]
    root = np.where(ln > 0, _entries(role, sym, ln), 0).astype(np.uint32)
    return pair_literals(root) if role == "litlen" else root


def root_lookup(tab: _Table, role: str, root: np.ndarray,
                bits: np.ndarray):
    """The kernel's ``lookup`` of 15-bit windows ``bits`` (LSB first):
    (entry uint32, ok bool) arrays, the root's entry where it has one (a
    pair's first literal),
    else the entry of ``decode_sym``'s 15-length compare (ok false where
    no length matches: length 1 and the symbol its index reaches)."""
    bits = np.asarray(bits, np.int64)
    e = root[bits & ((1 << ROOT_BITS[role]) - 1)]
    if role == "litlen":
        e = first_of(e)
    rev = _REV15_NP[bits]
    ln, off = _shortest(tab, rev, 15, range(1, 16))
    ok = ln > 0
    off = np.where(ok, off, (rev >> 14) - tab.first_code[1])
    ln = np.where(ok, ln, 1)
    idx = np.clip(np.asarray(tab.first_idx)[ln] + off, 0, MAXSYMS - 1)
    slow = _entries(role, np.asarray(tab.sorted_syms)[idx], ln)
    hit = (e & 15) != 0
    return np.where(hit, e, slow).astype(np.uint32), hit | ok


# --------------------------------------------------------------------------
# the plain version: one stream at a time
# --------------------------------------------------------------------------
def _peeker(row: np.ndarray, n_valid: int):
    """peek(p): the 32 bits at bit p (LSB first) of the row's first
    n_valid bytes, zeros past them."""
    nw = -(-n_valid // 4) + 2
    buf = np.zeros(4 * nw, np.uint8)
    buf[:n_valid] = row[:n_valid]
    w = buf.view("<u4").astype(np.uint64)
    dw = (w[:-1] | (w[1:] << np.uint64(32))).tolist()
    limit = len(dw)

    def peek(p: int) -> int:
        i = p >> 5
        return (dw[i] >> (p & 31)) & 0xFFFFFFFF if i < limit else 0

    return peek


def _symbol_loop(peek, out, bit_pos, hard_limit, out_cap, ll, of, chain):
    """The symbol loop of one Huffman block (``symbol_loop``, ``tpu.py:
    201``).  Appends to out; returns (bit_pos, result, running).  chain,
    a list [symbols, table lookups] or None, gets the block's symbols and
    their litlen and offset lookups added."""
    nsym = nmatch = 0
    try:
        while True:
            nsym += 1
            sym, ln, ok = _decode_sym(ll, peek(bit_pos) & 0x7FFF)
            nbp = bit_pos + ln
            bad = (not ok) or sym >= 286 or nbp > hard_limit
            out_pos = len(out)
            if sym < 256:
                if out_pos < out_cap:
                    out.append(sym)
                    bit_pos = nbp
                    if bad:
                        return bit_pos, RES_BAD, False
                    continue
                return nbp, RES_BAD if bad else RES_INSUFFICIENT, False
            if sym == 256 or bad:
                return nbp, RES_BAD if bad else RES_OK, not bad
            # a length symbol 257..285
            nmatch += 1
            lslot = sym - 257
            lxb = _LEN_EXTRA[lslot]
            length = _LEN_BASE[lslot] + (peek(nbp) & ((1 << lxb) - 1))
            bp2 = nbp + lxb
            osym, oln, ook = _decode_sym(of, peek(bp2) & 0x7FFF)
            bp3 = bp2 + oln
            oslot = min(osym, 29)
            oxb = _OFF_EXTRA[oslot]
            offset = _OFF_BASE[oslot] + (peek(bp3) & ((1 << oxb) - 1))
            bp4 = bp3 + oxb
            if (not ook) or osym >= 30 or offset > out_pos \
                    or bp4 > hard_limit:
                return bp4, RES_BAD, False
            if out_pos + length > out_cap:
                return bp4, RES_INSUFFICIENT, False
            src = out_pos - offset
            if offset >= length:
                out += out[src:src + length]
            else:                       # overlapping: the period repeats
                out += (out[src:out_pos] * (length // offset + 1))[:length]
            bit_pos = bp4
    finally:
        if chain is not None:
            chain[0] += nsym
            chain[1] += nsym + nmatch


def _dynamic_header(peek, bit_pos, hard_limit):
    """The header of a dynamic block (``block_dynamic``, ``tpu.py:316``):
    returns (bit_pos after it, good, ll table, offset table)."""
    bits = peek(bit_pos)
    num_litlen = 257 + (bits & 31)
    num_offsets = 1 + ((bits >> 5) & 31)
    num_explicit = 4 + ((bits >> 10) & 15)
    bp = bit_pos + 14
    pre_lens = [0] * 19
    for i in range(num_explicit):
        pre_lens[_PERM[i]] = peek(bp) & 7
        bp += 3
    ok, pre = _canon_tables(pre_lens, 19)
    total = num_litlen + num_offsets
    lens = [0] * (MAXSYMS + 32)
    i = 0
    while ok and i < total:
        sym, ln, dok = _decode_sym(pre, peek(bp) & 0x7FFF)
        nbp = bp + ln
        bits2 = peek(nbp)
        if sym < 16:
            rep, xb, val = 1, 0, sym
        elif sym == 16:
            rep, xb, val = 3 + (bits2 & 3), 2, lens[max(i - 1, 0)]
        elif sym == 17:
            rep, xb, val = 3 + (bits2 & 7), 3, 0
        else:
            rep, xb, val = 11 + (bits2 & 127), 7 if sym == 18 else 0, 0
        bad = ((not dok) or (sym == 16 and i == 0) or i + rep > total
               or nbp + xb > hard_limit)
        if not bad:
            lens[i:i + rep] = [val] * rep
        bp = nbp + xb
        i += rep
        ok = not bad
    if not ok:
        return bp, False, None, None
    ll_ok, ll = _canon_tables(lens[:MAXSYMS], num_litlen)
    of_ok, of = _canon_tables(lens[num_litlen:], num_offsets)
    return bp, ll_ok and of_ok, ll, of


def _decode_row(row: np.ndarray, in_nbytes: int, out_cap: int,
                chain=None):
    """Decode one stream (``deflate_decompress_chunk``): returns
    (bytearray, out_len, consumed, result).  chain, a list [symbols, table
    lookups] or None, gets the stream's counts added."""
    n_valid = min(max(in_nbytes, 0), row.shape[0])
    peek = _peeker(row, n_valid)
    total_bits = in_nbytes * 8
    hard_limit = total_bits + 49  # implicit-zero overread budget (~6 bytes)
    out = bytearray()
    bit_pos, result, running, is_final = 0, RES_OK, True, False
    while running and not is_final:
        bits = peek(bit_pos)
        is_final = bool(bits & 1)
        btype = (bits >> 1) & 3
        overran = bit_pos + 3 > hard_limit
        bit_pos += 3
        if overran or btype == 3:
            result, running = RES_BAD, False
        elif btype == 0:
            byte = ((bit_pos + 7) & ~7) >> 3
            w = peek(byte * 8)
            length, nlen = w & 0xFFFF, (w >> 16) & 0xFFFF
            ok = (length ^ 0xFFFF) == nlen
            fits_in = byte + 4 + length <= in_nbytes
            fits_out = len(out) + length <= out_cap
            running = ok and fits_in and fits_out
            if running:
                # the bytes of the input window, zeros past the data
                seg = row[byte + 4:min(byte + 4 + length, n_valid)]
                out += seg.tobytes()
                out += bytes(length - len(seg))
                bit_pos = (byte + 4 + length) * 8
            else:
                result = RES_INSUFFICIENT if ok and not fits_out else RES_BAD
        else:
            if btype == 1:
                good, ll, of = True, _ST_LL, _ST_OF
            else:
                bit_pos, good, ll, of = _dynamic_header(peek, bit_pos,
                                                        hard_limit)
            if good:
                bit_pos, result, running = _symbol_loop(
                    peek, out, bit_pos, hard_limit, out_cap, ll, of, chain)
            else:
                result, running = RES_BAD, False
    ok = running and bit_pos <= total_bits
    if not ok and result == RES_OK:
        result = RES_BAD
    elif ok:
        result = RES_OK
    return out, len(out), min((bit_pos + 7) >> 3, in_nbytes), result


def decode_chunks_fsm_plain(bufs: torch.Tensor, in_lens: torch.Tensor,
                            out_cap: int, chain: np.ndarray | None = None):
    """Plain version of F1 on CPU tensors: a sequential port of
    ``deflate_decompress_chunk`` in Python integers, one row at a time
    (about 0.6 s per MiB of zlib level-6 text).  Same arguments and
    results as ``decompress_chunks``.  chain, an int64 [2, B] array or
    None, gets each row's symbols (EOBs included) and its litlen and
    offset table lookups: every lookup waits for the one before it, so
    the row with the most lookups times one dependent load is the floor
    of a decode that runs a row's chain on one warp."""
    B = bufs.shape[0]
    rows = bufs.contiguous().numpy()
    lens = in_lens.tolist()
    out = np.zeros((B, out_cap), np.uint8)
    res = np.zeros((3, B), np.int32)
    for k in range(B):
        counts = [0, 0]
        buf, n, cons, result = _decode_row(rows[k], lens[k], out_cap, counts)
        if chain is not None:
            chain[:, k] = counts
        out[k, :n] = np.frombuffer(bytes(buf), np.uint8)
        res[:, k] = (n, cons, result)
    out_lens, consumed, result = torch.from_numpy(res)
    return torch.from_numpy(out), out_lens, consumed, result


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def decompress_chunks(bufs, in_lens, out_cap: int, device=None):
    """Decode B raw-DEFLATE streams (``tpu.py:433``).

    bufs: uint8 [B, N], each stream at the start of its row.
    in_lens: [B] byte counts (held as int32); bytes past them read as zero.
    out_cap: per-stream output capacity.

    Runs on CUDA unless ``device`` names another device: the CUDA kernel
    for CUDA tensors, ``decode_chunks_fsm_plain`` for CPU tensors.
    Returns (out uint8[B, out_cap], out_lens int32[B], consumed int32[B],
    result int32[B]); out is zero past each out_len."""
    dev = resolve_device(device)
    bufs = as_tensor(bufs, np.uint8).to(dev)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs must be uint8[B, N], got {bufs.dtype} "
                         f"{tuple(bufs.shape)}")
    B, N = bufs.shape
    in_lens = as_tensor(in_lens, np.int32).to(dev, torch.int32).contiguous()
    if in_lens.shape != (B,):
        raise ValueError("in_lens must have shape [B]")
    if not (0 <= out_cap <= MAX_BYTES and N <= MAX_BYTES):
        raise ValueError(f"N ({N}) and out_cap ({out_cap}) must lie in "
                         f"[0, {MAX_BYTES}]")
    if dev.type == "cpu":
        return decode_chunks_fsm_plain(bufs, in_lens, out_cap)
    if dev.type != "cuda":
        raise ValueError(f"decompress_chunks runs on CUDA or the CPU, not "
                         f"{dev}")
    bufs = bufs.contiguous()
    out = torch.empty(B, out_cap, dtype=torch.uint8, device=dev)
    res = torch.empty(3, B, dtype=torch.int32, device=dev)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel("fsm_decode", "fsm_decode_launch",
                       [P, I, I, P, I, P, P, P, P, P])
    p = ctypes.c_void_p
    with _build.launch_context((bufs, in_lens, out, res),
                               "fsm_decode") as stream:
        err = fn(p(bufs.data_ptr()), B, N, p(in_lens.data_ptr()), out_cap,
                 p(out.data_ptr()), p(res[0].data_ptr()),
                 p(res[1].data_ptr()), p(res[2].data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"fsm_decode kernel failed to launch: CUDA error "
                           f"{err}")
    _build.count_launch(decompress_chunks)
    return out, res[0], res[1], res[2]


def deflate_decompress_chunk(data, in_nbytes: int, out_cap: int,
                             device=None):
    """Decode one raw-DEFLATE stream (uint8 [N]) into uint8 [out_cap]
    (``tpu.py:168``): a batch of one through ``decompress_chunks``.
    Returns (out, out_len, in_consumed_bytes, result), the last three as
    0-d int32 tensors."""
    data = as_tensor(data, np.uint8)
    if data.dim() != 1:
        raise ValueError(f"data must be uint8[N], got {tuple(data.shape)}")
    out, out_lens, consumed, result = decompress_chunks(
        data[None], torch.tensor([int(in_nbytes)], dtype=torch.int32),
        out_cap, device=device)
    return out[0], out_lens[0], consumed[0], result[0]


reset_launch_counts()
