"""LSB-first bit writing on the host.

The port's own copy of ``BitWriter``
(``libdeflate_tpu/compress/emit.py:46-112``), which
``parallel/file_codec.stored_fragment`` writes with: ``add``,
``align_to_byte`` and ``finish``.  The rest of ``emit.py``, ``add_words``
and ``bit_length`` with it, belongs to the host engine.
"""

from __future__ import annotations


class BitWriter:
    """LSB-first bit accumulator producing a byte stream."""

    __slots__ = ("bitbuf", "bitcount", "out")

    def __init__(self):
        self.bitbuf = 0
        self.bitcount = 0
        self.out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        self.bitbuf |= value << self.bitcount
        self.bitcount += nbits
        if self.bitcount >= 64:
            self.out += (self.bitbuf & (2**64 - 1)).to_bytes(8, "little")
            self.bitbuf >>= 64
            self.bitcount -= 64

    def align_to_byte(self) -> None:
        pad = (-self.bitcount) % 8
        if pad:
            self.add(0, pad)
        while self.bitcount >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcount -= 8

    def finish(self) -> bytes:
        self.align_to_byte()
        assert self.bitcount == 0
        return bytes(self.out)

