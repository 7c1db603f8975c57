"""A plain Python inflater of raw DEFLATE (RFC 1951), and the decode
control.

``inflate(stream)`` is the straightforward decoder: stored, fixed and
dynamic blocks, matches copied byte by byte where they overlap.  It is
slow (a few MB/s) and serves the tests, which hold it to zlib, and the
decode cells' control.

``inflate(stream, split=h)`` is that control: the speculative decoder
that a later change may be tempted by, which decodes a chunk's second
half from its own start without the first half's bytes as its window.
Once the output reaches ``h`` bytes (at the next token), every byte
before it reads as 0 to the matches that follow; the first half is
returned as decoded.  Where a match after the split reaches back across
it, the bytes come out wrong, which the decode cells' comparison has to
catch.
"""

from __future__ import annotations

LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
             4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
              10, 10, 11, 11, 12, 12, 13, 13)
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


class DataError(ValueError):
    """The stream is not valid DEFLATE."""


def table(lengths) -> tuple[list[int], int]:
    """A canonical Huffman code as a lookup table indexed by the next
    ``bits`` input bits (LSB first): entry sym << 4 | length, 0 where no
    code matches.  Returns (table, bits)."""
    bits = max(lengths, default=0)
    if bits == 0:
        return [0], 0
    count = [0] * (bits + 1)
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, nxt = 0, [0] * (bits + 2)
    for n in range(1, bits + 1):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    tab = [0] * (1 << bits)
    for sym, n in enumerate(lengths):
        if n == 0:
            continue
        c = nxt[n]
        nxt[n] += 1
        rev = int(f"{c:0{n}b}"[::-1], 2)
        for fill in range(rev, 1 << bits, 1 << n):
            tab[fill] = sym << 4 | n
    return tab, bits


FIXED_LIT = table([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
FIXED_DIST = table([5] * 30)


def inflate(stream: bytes, split: int | None = None) -> bytes:
    """The bytes of one raw-DEFLATE stream (to its final block); with
    ``split``, the decode control described above.  Raises DataError on
    a stream that is not valid DEFLATE."""
    try:
        return _inflate(stream, split)
    except IndexError:
        raise DataError("stream truncated") from None


def _inflate(stream: bytes, split: int | None) -> bytes:
    src = stream + b"\x00" * 8
    end_bits = 8 * len(stream)
    pos, buf, cnt = 0, 0, 0          # next byte, bit buffer, bits in it
    out = bytearray()
    first = None                     # the first half, once split

    def need(n):
        nonlocal pos, buf, cnt
        while cnt < n:
            buf |= src[pos] << cnt
            pos += 1
            cnt += 8

    def take(n):
        nonlocal buf, cnt
        need(n)
        v = buf & ((1 << n) - 1)
        buf >>= n
        cnt -= n
        return v

    def sym(tab):
        nonlocal buf, cnt
        t, bits = tab
        need(bits)
        e = t[buf & ((1 << bits) - 1)]
        if e == 0:
            raise DataError("no code matches")
        n = e & 15
        buf >>= n
        cnt -= n
        return e >> 4

    final = 0
    while not final:
        final = take(1)
        btype = take(2)
        if btype == 0:
            buf >>= cnt & 7
            cnt -= cnt & 7
            size, nsize = take(16), take(16)
            if size != (~nsize & 0xFFFF):
                raise DataError("stored LEN and NLEN disagree")
            while cnt and size:          # bytes already in the buffer
                out.append(take(8))
                size -= 1
            if pos + size > len(stream):
                raise DataError("stored block past the end")
            out += src[pos:pos + size]
            pos += size
            continue
        if btype == 1:
            lit, dist = FIXED_LIT, FIXED_DIST
        elif btype == 2:
            nlit, ndist, ncl = take(5) + 257, take(5) + 1, take(4) + 4
            cl = [0] * 19
            for i in range(ncl):
                cl[CL_ORDER[i]] = take(3)
            cltab = table(cl)
            lens = []
            while len(lens) < nlit + ndist:
                s = sym(cltab)
                if s < 16:
                    lens.append(s)
                elif s == 16:
                    if not lens:
                        raise DataError("repeat with no length before it")
                    lens += [lens[-1]] * (3 + take(2))
                else:
                    lens += [0] * ((3 + take(3)) if s == 17 else (11 + take(7)))
            if len(lens) > nlit + ndist or lens[256] == 0:
                raise DataError("bad code lengths")
            lit, dist = table(lens[:nlit]), table(lens[nlit:])
        else:
            raise DataError("reserved block type")
        while True:
            if split is not None and first is None and len(out) >= split:
                first = bytes(out)
                out[:] = bytes(len(out))
            s = sym(lit)
            if s < 256:
                out.append(s)
                continue
            if s == 256:
                break
            if s > 285:
                raise DataError("bad length symbol")
            s -= 257
            length = LEN_BASE[s] + take(LEN_EXTRA[s])
            d = sym(dist)
            if d > 29:
                raise DataError("bad distance symbol")
            back = DIST_BASE[d] + take(DIST_EXTRA[d])
            if back > len(out):
                raise DataError("distance before the start")
            at = len(out) - back
            if back >= length:
                out += out[at:at + length]
            else:
                run = out[at:]
                out += (run * (length // back + 1))[:length]
        if 8 * pos - cnt > end_bits:
            raise DataError("stream truncated")
    if first is not None:
        return first + bytes(out[len(first):])
    return bytes(out)
