"""Adler-32 and CRC-32 of padded chunk batches, in torch ops.

Counterpart of ``libdeflate_tpu/ops/checksums_jax.py`` (lines 57-253):
``adler32_fixed``, ``crc32_fixed``, ``adler32_chunks`` and ``crc32_chunks``.
The JAX package has no Pallas kernel here, so neither has the port: the JAX
``vmap`` over chunks becomes a batch dimension written out, and the two
matrix products stay ``torch.matmul``.

- Adler-32: one product of the bytes, as a [rows, 256] tile per chunk, with
  the weight columns (1, column index) gives each row's sum and weighted
  sum; the row straddling ``length`` is recomputed exactly on the side.
- CRC-32: the bits of each 2048-byte block times the constant contribution
  matrix ``BLOCK_BITS_MATRIX``, mod 2, give each block's raw register; a
  log-depth tree of advance matrices combines the blocks; one dynamic
  inverse advance rewinds the zero padding past ``length``, and the advanced
  initial register is folded in.

The products run in float32, on the CPU and on the card.  The JAX code
multiplies bf16 into f32 and int8 into int32; a torch bf16 product returns
bf16, which rounds the CRC's 0/1 sums (up to 8 * 2048) and so loses the
parity bit that is all the CRC keeps, and CUDA has no int8 ``torch.matmul``.
Every operand is an integer of at most 255 (TF32 keeps 10 mantissa bits)
and every sum is below 2**24 (Adler: 256 * 255 * 255; CRC: 16384), so the
products are exact in float32 and in TF32 alike: each is the plain
``torch.matmul`` under whatever TF32 setting the caller chose, and the
module writes no process-wide setting (the mesh's shards run it from
threads of their own).

Registers and sums are int64 holding unsigned 32-bit values: torch's
``uint32`` has no shifts, adds or compares on the CPU.  Results are int64
tensors with values below 2**32.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .crc32_math import (
    ADVANCE_POW2,
    BLOCK_BITS_MATRIX,
    CRC_BLOCK,
    INV_ADVANCE_POW2,
)

ADLER_MOD = 65521
# 256 bytes per row: row sums stay < 256 * 255 * 255 < 2**24, exact in f32
_ADLER_LANES = 256
_CRC_LOG_BLOCK = CRC_BLOCK.bit_length() - 1
_M32 = 0xFFFFFFFF


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _bits_matrix(cols: np.ndarray) -> np.ndarray:
    """[..., 32] uint32 columns -> [..., 32, 32] float32 0/1 with [j, i] =
    bit i of column j, so that v's bits @ it, mod 2, are M @ v's bits."""
    return ((cols[..., None].astype(np.int64) >> np.arange(32)) & 1).astype(
        np.float32)


_ADV_BITS = _bits_matrix(ADVANCE_POW2)           # [40, 32, 32]
_IADV_BITS = _bits_matrix(INV_ADVANCE_POW2)      # [40, 32, 32]
# [8 * CRC_BLOCK, 32]: row p*8 + k is bit k of block byte p's contribution
_BLOCK_MAT = _bits_matrix(BLOCK_BITS_MATRIX)


# the constant matrices per device: a 2 MiB host-to-device copy in every
# call would cost time and cannot be captured in a CUDA graph
_on_device: dict[torch.device, tuple] = {}
_on_device_lock = threading.Lock()


def _matrices(dev: torch.device):
    """(block matrix, advance bits, inverse advance bits) on dev, copied
    once per device: under a lock, and finished before any thread reads
    them, whatever stream it reads them on."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mats = _on_device.get(dev)
    if mats is None:
        with _on_device_lock:
            mats = _on_device.get(dev)
            if mats is None:
                mats = tuple(torch.as_tensor(m, device=dev) for m in
                             (_BLOCK_MAT, _ADV_BITS, _IADV_BITS))
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                _on_device[dev] = mats
    return mats



def _gf2_apply(mbits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The GF(2) matrix(es) ``mbits`` ([32, 32] or [..., 32, 32], from
    ``_bits_matrix``) applied to the int64 registers ``v``."""
    sh = torch.arange(32, device=v.device)
    vb = ((v[..., None] >> sh) & 1).to(torch.float32)
    s = torch.matmul(vb[..., None, :], mbits)[..., 0, :]   # sums <= 32
    return ((s.to(torch.int64) & 1) << sh).sum(-1)


def _advance_dyn(reg: torch.Tensor, nbytes: torch.Tensor,
                 mats: torch.Tensor) -> torch.Tensor:
    """Advance registers past a per-row number of zero bytes (or rewind,
    with the inverse matrices): ``_advance_dyn`` of the JAX code, which
    applies ``mats[j]`` for each set bit j of ``nbytes`` in turn.  Here
    the 32 matrices the bits select (the identity where a bit is clear)
    are multiplied in a log-depth tree, mod 2, and applied once: a few
    dozen ops where the loop takes some 500, which the mesh's shard
    threads each pay for.  The matrices are powers of one advance, so
    they commute and the order of the products does not matter; the 0/1
    sums are at most 32, exact in float32 and TF32."""
    sh = torch.arange(32, device=reg.device)
    bit = ((nbytes[..., None] >> sh) & 1).bool()
    m = torch.where(bit[..., None, None], mats[:32],
                    torch.eye(32, device=reg.device))
    while m.shape[-3] > 1:
        m = (torch.matmul(m[..., 0::2, :, :], m[..., 1::2, :, :]).to(
            torch.int64) & 1).to(torch.float32)
    return _gf2_apply(m[..., 0, :, :], reg)


def _rows_u8(bufs, lengths, inits, dev):
    bufs = as_tensor(bufs, np.uint8).to(dev)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs must be uint8 [B, N], got {bufs.dtype} "
                         f"{tuple(bufs.shape)}")
    lengths = as_tensor(lengths, np.int64).to(dev, torch.int64)
    inits = as_tensor(inits, np.int64).to(dev, torch.int64) & _M32
    B = bufs.shape[0]
    if lengths.shape != (B,) or inits.shape != (B,):
        raise ValueError("lengths and inits must have shape [B]")
    return bufs, lengths, inits


def adler32_rows(bufs, lengths, inits, device=None) -> torch.Tensor:
    """Adler-32 of bufs[b, :lengths[b]] from inits[b], for every row b.

    bufs: uint8 [B, N]; lengths: [B] with 0 <= lengths <= N; inits: [B]
    32-bit initial values.  Returns int64 [B].  Runs on CUDA unless
    ``device`` names another device."""
    dev = resolve_device(device)
    bufs, length, init = _rows_u8(bufs, lengths, inits, dev)
    B, n = bufs.shape
    M = ADLER_MOD
    cols = min(_ADLER_LANES, _ceil_to(max(n, 1), 128))
    rows = max(_ceil_to(n, cols) // cols, 1)
    s1_init = init & 0xFFFF
    s2_init = init >> 16

    # each row's byte sum and weighted sum (weights = column index) in one
    # product; exact, see the module docstring
    b2 = torch.nn.functional.pad(bufs, (0, rows * cols - n)).reshape(
        B, rows, cols)
    lane = torch.arange(cols, device=dev)
    wts = torch.stack([torch.ones(cols, device=dev),
                       lane.to(torch.float32)], 1)
    sums = torch.matmul(b2.to(torch.float32), wts).to(torch.int64)

    # the row holding the end of the data, masked exactly
    r_b = torch.clamp(length // cols, max=rows - 1)
    rem = length - r_b * cols                  # valid bytes in row r_b
    prow = b2[torch.arange(B, device=dev), r_b].to(torch.int64)
    prow = torch.where(lane < rem[:, None], prow, 0)
    psum = prow.sum(1, keepdim=True)
    pwsum = (prow * lane).sum(1, keepdim=True)

    rid = torch.arange(rows, device=dev)[None]
    full = rid < r_b[:, None]
    at_b = rid == r_b[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    row_sum = torch.where(full, sums[..., 0], torch.where(at_b, psum, zero))
    row_wsum = torch.where(full, sums[..., 1], torch.where(at_b, pwsum, zero))

    s1 = (s1_init + (row_sum % M).sum(1)) % M
    # weighted = sum_i (length - i) * b_i
    #          = sum_r [(length - r * cols) * S_r - W_r]            (mod M)
    w_r = (length[:, None] - rid * cols) % M   # rows past length: S_r = 0
    prod = (w_r * (row_sum % M)) % M
    weighted = (prod.sum(1) - (row_wsum % M).sum(1)) % M
    len_s1 = ((length % M) * s1_init) % M
    s2 = (s2_init + len_s1 + weighted) % M
    return (s2 << 16) | s1


def crc32_rows(bufs, lengths, inits, device=None) -> torch.Tensor:
    """gzip CRC-32 of bufs[b, :lengths[b]] from inits[b], for every row b.

    Bytes past ``length`` are masked to zero and the block reduction runs
    over the whole window rounded up to 2048 bytes; the result is the
    register of message ++ zeros, which one dynamic inverse advance rewinds
    to the true register.  Same arguments and result as ``adler32_rows``.

    Memory: the bit operand is [B * nb, 16384] float32, nb = N / 2048
    rounded up, i.e. 32 bytes per input byte: 256 MiB for 8 x 1 MiB, which
    the card holds."""
    dev = resolve_device(device)
    bufs, length, init = _rows_u8(bufs, lengths, inits, dev)
    B, n = bufs.shape
    size = _ceil_to(max(n, 1), CRC_BLOCK)
    nb = size // CRC_BLOCK
    idx = torch.arange(n, device=dev)
    masked = torch.where(idx < length[:, None], bufs,
                         torch.zeros((), dtype=torch.uint8, device=dev))
    window = torch.nn.functional.pad(masked, (0, size - n))

    # intra-block reduction: the 8 bits of every byte, [byte, bit] order,
    # times the block matrix, mod 2 (exact, see the module docstring)
    bits = (window.reshape(B * nb, CRC_BLOCK, 1)
            >> torch.arange(8, dtype=torch.uint8, device=dev)) & 1
    block_mat, adv, iadv = _matrices(dev)
    s = torch.matmul(bits.reshape(B * nb, 8 * CRC_BLOCK).to(torch.float32),
                      block_mat)
    sh = torch.arange(32, device=dev)
    v = ((s.to(torch.int64) & 1) << sh).sum(-1).reshape(B, nb)

    # combine tree at block granularity, zero registers padded on the left
    nb2 = 1 << max((nb - 1).bit_length(), 0)
    v = torch.nn.functional.pad(v, (nb2 - nb, 0))
    for level in range(nb2.bit_length() - 1):
        v = _gf2_apply(adv[_CRC_LOG_BLOCK + level], v[:, 0::2]) ^ v[:, 1::2]
    # rewind the trailing zero padding, then fold in the advanced init
    raw = _advance_dyn(v[:, 0], size - length, iadv)
    init_reg = _advance_dyn(init ^ _M32, length, adv)
    return (init_reg ^ raw) ^ _M32


def _one(fn, buf, length, init, device):
    buf = as_tensor(buf, np.uint8)
    if buf.dim() != 1:
        raise ValueError(f"buf must be uint8 [N], got {tuple(buf.shape)}")
    return fn(buf[None], [int(length)], [int(init)], device=device)[0]


def adler32_fixed(buf, length: int, adler_init: int = 1, device=None):
    """Adler-32 of buf[:length] from ``adler_init``: buf uint8 [N].
    Returns an int64 scalar tensor."""
    return _one(adler32_rows, buf, length, adler_init, device)


def crc32_fixed(buf, length: int, crc_init: int = 0, device=None):
    """gzip CRC-32 of buf[:length] from ``crc_init``: buf uint8 [N].
    Returns an int64 scalar tensor."""
    return _one(crc32_rows, buf, length, crc_init, device)


def adler32_chunks(bufs, lengths, device=None) -> torch.Tensor:
    """Per-chunk Adler-32 (init 1) over a [B, N] padded chunk array."""
    dev = resolve_device(device)
    inits = torch.ones(len(bufs), dtype=torch.int64, device=dev)
    return adler32_rows(bufs, lengths, inits, device=dev)


def crc32_chunks(bufs, lengths, device=None) -> torch.Tensor:
    """Per-chunk CRC-32 (init 0) over a [B, N] padded chunk array."""
    dev = resolve_device(device)
    inits = torch.zeros(len(bufs), dtype=torch.int64, device=dev)
    return crc32_rows(bufs, lengths, inits, device=dev)
