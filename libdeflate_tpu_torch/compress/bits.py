"""32-bit word arithmetic on int64 tensors, and the matchfind's
constants and word helpers: the compress layer's primitives, which every
kernel wrapper and stage imports and which import nothing of the package.

Counterpart of ``libdeflate_tpu/compress/tpu_pipeline.py``'s constants
(lines 60-81), its arithmetic codeword helpers (``_rev16``, ``_rev``,
``_bsr``, ``_length_slot``, ``_offset_slot``, 87-157), ``_le32_words``
(163) and ``_segment_sizes`` (175).

The JAX code computes in uint32.  PyTorch's ``uint32`` lacks shifts,
comparisons and ``add`` on the CPU, and ``>>`` on int32 is arithmetic, so
the port holds every 32-bit word as a non-negative int64 and masks with
``M32`` wherever a uint32 result would have wrapped.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

MULT = 0x1E35A7BD
HASH_ORDER = 15
MIN_MATCH = 4
SORT_SEG = 65536
POS_BITS = 16
WINDOW = 32768
FSM_SEG = 512
MAX_LEN = 258
GROUP = 128
GROUP_CAPW = 37    # 128 positions x <= 9 bits + a carry word
DEPTH = 6          # sorted-order neighbours probed per position
STRIDES = (1, 2, 4, 8, 16, 32, 64, 128)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensor with the same bits."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> int64 words in [0, 2**32) with the same bits."""
    return x.to(torch.int64) & M32


def rev16(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 16 bits (``_rev16``)."""
    x = x & M32
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x


def rev(x: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Bit-reverse x within nbits, nbits in 0..16 (``_rev``)."""
    return rev16(x) >> (16 - nbits)


def bsr(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) for x < 2**31 (``_bsr``).  The frexp
    exponent of a float64 is exact for every integer below 2**53."""
    x = torch.clamp(x.to(torch.int64), min=1)
    return (torch.frexp(x.to(torch.float64))[1] - 1).to(torch.int64)


def length_slot(mlen: torch.Tensor):
    """(slot, base, extra_bits) for match length 3..258 (``_length_slot``)."""
    l1 = mlen.to(torch.int64) - 3
    k = bsr(torch.clamp(l1, min=1))
    band_slot = 4 * k - 4 + ((l1 >> torch.clamp(k - 2, min=0)) & 3)
    slot = torch.where(mlen <= 10, l1,
                       torch.where(mlen >= 258, 28, band_slot))
    extra = torch.where(slot < 8, 0,
                        torch.where(slot >= 28, 0, (slot >> 2) - 1))
    base = torch.where(
        slot < 8, slot + 3,
        torch.where(slot >= 28, 258,
                    3 + ((4 + (slot & 3))
                         << torch.clamp((slot >> 2) - 1, min=0))))
    return slot, base, extra


def offset_slot(off: torch.Tensor):
    """(slot, base, extra_bits) for offset 1..32768 (``_offset_slot``)."""
    o1 = off.to(torch.int64) - 1
    k = bsr(torch.clamp(o1, min=1))
    half = (o1 >> torch.clamp(k - 1, min=0)) & 1
    slot = torch.where(off <= 4, off.to(torch.int64) - 1, 2 * k + half)
    extra = torch.where(slot < 4, 0, (slot >> 1) - 1)
    base = torch.where(
        slot < 4, slot + 1,
        1 + ((2 + (slot & 1)) << torch.clamp((slot >> 1) - 1, min=0)))
    return slot, base, extra


def seg_key_params(seg: int) -> tuple[int, int]:
    """(pos_bits, junk_hash) for a matchfind segment size."""
    pos_bits = max(POS_BITS, (seg - 1).bit_length())
    junk = (1 << HASH_ORDER) - 1 if pos_bits >= 17 else (1 << HASH_ORDER)
    return pos_bits, junk


def segment_sizes(n: int, wide: bool = True) -> tuple[int, int, int]:
    """(padded_n, sort_seg, fsm_seg) for a chunk of n positions
    (``_segment_sizes``).  ``wide`` gives the single-pass tiers' 128 KiB
    matchfind segments (lean and dyn1); the static tier and the two-pass
    tiers pass False for 64 KiB ones."""
    seg = 2 * SORT_SEG if wide else SORT_SEG
    if n >= seg:
        return -(-n // seg) * seg, seg, FSM_SEG
    if n >= FSM_SEG:
        np_ = -(-n // FSM_SEG) * FSM_SEG
        return np_, np_, FSM_SEG
    np_ = -(-n // GROUP) * GROUP
    return np_, np_, np_


def ahead(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[..., i + s] along the last axis, zero past the end."""
    return torch.cat([x[..., s:], torch.zeros_like(x[..., :s])], dim=-1)


def behind(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x[..., i - 1] along the last axis, ``fill`` at the start."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def le32_words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian 32-bit word starting at every byte position (zero
    bytes past the end)."""
    n = b.shape[-1]
    bp = torch.cat([b.to(torch.int64),
                    torch.zeros_like(b[..., :1], dtype=torch.int64)
                    .expand(*b.shape[:-1], 3)], dim=-1)
    return (bp[..., :n] | (bp[..., 1:n + 1] << 8)
            | (bp[..., 2:n + 2] << 16) | (bp[..., 3:n + 3] << 24))
