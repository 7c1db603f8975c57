"""The port's host tables, Huffman builders and emit helpers against the JAX
package's.

``libdeflate_tpu_torch.formats.deflate`` (slot tables, ``offset_to_slot``,
static codes, ``reverse_bits``, ``canonical_codes``, the precode
permutation, the block-length constants), ``huffman.build``
(``package_merge_lengths``, ``make_huffman_code``), ``huffman.decode_table``
(the packed host decode tables, valid, over-full and incomplete codes),
``compress.emit`` (``rle_encode_lens``, ``pack_bits_vectorized``,
``item_symbols``, ``block_histograms``, ``BlockCodes``, the cost helpers,
``emit_stored``, ``emit_items``, ``flush_block``) and the engine's level
tables, each held to its original in ``libdeflate_tpu`` on the same inputs,
made from a seed with numpy.  All host integer code: tolerance exact.
"""

import numpy as np
import pytest

from libdeflate_tpu.compress import emit as jemit
from libdeflate_tpu.compress import parse_host as jparse
from libdeflate_tpu.compress import parse_optimal as jopt
from libdeflate_tpu.formats import deflate as jdeflate
from libdeflate_tpu.huffman import build as jbuild
from libdeflate_tpu.huffman import decode_table as jdt
from libdeflate_tpu_torch.compress import emit, parse_host, parse_optimal
from libdeflate_tpu_torch.decompress import tables
from libdeflate_tpu_torch.formats import deflate
from libdeflate_tpu_torch.huffman import build, decode_table as dt


def _constants(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, (int, np.ndarray))}


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("port,ref", [(deflate, jdeflate), (dt, jdt),
                                      (emit, jemit)],
                         ids=["deflate", "decode_table", "emit"])
def test_module_constants_equal(port, ref):
    mine, theirs = _constants(port), _constants(ref)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert _same(mine[k], theirs[k]), k


def test_decoder_tables_agree_with_the_format_tables():
    # decompress/tables.py keeps K3's own copies of the shared values
    assert np.array_equal(tables.LEN_BASE, deflate.LENGTH_SLOT_BASE)
    assert np.array_equal(tables.LEN_EXTRA, deflate.LENGTH_SLOT_EXTRA)
    assert np.array_equal(tables.OFF_BASE, deflate.OFFSET_SLOT_BASE)
    assert np.array_equal(tables.OFF_EXTRA, deflate.OFFSET_SLOT_EXTRA)
    assert np.array_equal(tables.PRECODE_PERM,
                          deflate.PRECODE_LENS_PERMUTATION)
    assert np.array_equal(tables.STATIC_LENS[:288], deflate.STATIC_LITLEN_LENS)
    assert np.array_equal(tables.STATIC_LENS[288:],
                          deflate.STATIC_OFFSET_LENS)


def test_offset_to_slot_equal():
    offs = np.arange(1, deflate.MAX_MATCH_OFFSET + 1)
    assert _same(deflate.offset_to_slot(offs), jdeflate.offset_to_slot(offs))
    for off in (1, 2, 5, 256, 257, 1024, 32768):
        assert deflate.offset_to_slot(off) == jdeflate.offset_to_slot(off)


@pytest.mark.parametrize("seed", range(4))
def test_bit_and_code_helpers_equal(seed):
    rng = np.random.default_rng(seed)
    nbits = rng.integers(1, 16, 500)
    codes = rng.integers(0, 1 << 15, 500) & ((1 << nbits) - 1)
    assert _same(deflate.reverse_bits(codes, nbits),
                 jdeflate.reverse_bits(codes, nbits))
    lens = jbuild.package_merge_lengths(
        rng.integers(0, 50, 288) * (rng.random(288) < 0.7), 15)
    assert _same(deflate.canonical_codes(lens), jdeflate.canonical_codes(lens))


def _freq_sets():
    rng = np.random.default_rng(0x4B1D)
    sets = [
        ("all zero", np.zeros(288, np.int64), 14),
        ("one symbol", np.eye(1, 288, 65, dtype=np.int64)[0] * 9, 14),
        ("two symbols", np.eye(1, 30, 3, dtype=np.int64)[0]
         + np.eye(1, 30, 29, dtype=np.int64)[0], 15),
        # Fibonacci weights force the length limit on every max_len
        ("fibonacci 19, limit 7",
         np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610,
                   987, 1597, 2584, 4181], np.int64), 7),
        ("geometric 288, limit 14", (2 ** np.minimum(np.arange(288), 40))
         .astype(np.int64), 14),
        ("equal 32", np.full(32, 7, np.int64), 15),
    ]
    for k in range(6):
        n = (19, 30, 288)[k % 3]
        lim = (7, 15, 14)[k % 3]
        f = rng.integers(0, 1000, n) * (rng.random(n) < 0.6)
        sets.append((f"seeded {n}, limit {lim}", f.astype(np.int64), lim))
    return sets


@pytest.mark.parametrize("name,freqs,max_len", _freq_sets(),
                         ids=[s[0] for s in _freq_sets()])
def test_huffman_build_equal(name, freqs, max_len):
    lens = build.package_merge_lengths(freqs, max_len)
    assert _same(lens, jbuild.package_merge_lengths(freqs, max_len))
    assert int(lens.max()) <= max_len
    assert _same(build.make_huffman_code(freqs, max_len),
                 jbuild.make_huffman_code(freqs, max_len))


def _length_sets():
    rng = np.random.default_rng(0xDEC0DE)
    valid = jbuild.package_merge_lengths(rng.integers(1, 100, 288), 15)
    over = valid.copy()
    over[np.flatnonzero(over == over.max())[0]] -= 1   # over-full
    gap = valid.copy()
    gap[np.flatnonzero(gap)[-1]] = 0                   # incomplete
    return [
        ("litlen", "static", deflate.STATIC_LITLEN_LENS),
        ("offset", "static", deflate.STATIC_OFFSET_LENS),
        ("litlen", "seeded valid", valid),
        ("litlen", "over-full", over),
        ("litlen", "incomplete", gap),
        ("litlen", "deep subtables",
         jbuild.package_merge_lengths(2 ** np.minimum(np.arange(288), 40),
                                      15)),
        ("offset", "empty", np.zeros(32, np.int64)),
        ("offset", "one length-1 codeword", np.eye(1, 32, 7,
                                                   dtype=np.int64)[0]),
        ("offset", "one length-2 codeword", 2 * np.eye(1, 32, 7,
                                                       dtype=np.int64)[0]),
        ("offset", "two length-1 codewords", np.eye(1, 32, 0, dtype=np.int64)[0]
         + np.eye(1, 32, 31, dtype=np.int64)[0]),
        ("precode", "seeded valid",
         jbuild.package_merge_lengths(rng.integers(1, 30, 19), 7)),
        ("precode", "empty", np.zeros(19, np.int64)),
        ("precode", "over-full", np.ones(19, np.int64)),
        ("litlen", "all length 9", np.full(288, 9, np.int64)),
    ]


@pytest.mark.parametrize("role,name,lens", _length_sets(),
                         ids=[f"{r}-{n}" for r, n, _ in _length_sets()])
def test_decode_tables_equal(role, name, lens):
    got = getattr(dt, f"build_{role}_table")(lens)
    want = getattr(jdt, f"build_{role}_table")(lens)
    assert (got is None) == (want is None)
    if want is not None:
        assert _same(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_rle_and_pack_equal(seed):
    rng = np.random.default_rng(100 + seed)
    lens = rng.integers(0, 16, 320) * (rng.random(320) < 0.5)
    # long runs of zeros and of one length, past every precode repeat cap
    lens[40:200] = 0
    lens[210:225] = 8
    assert _same(emit.rle_encode_lens(lens), jemit.rle_encode_lens(lens))
    nbits = rng.integers(0, 33, 1000)
    values = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    assert _same(emit.pack_bits_vectorized(values, nbits),
                 jemit.pack_bits_vectorized(values, nbits))


def _items(rng, n):
    kinds = (rng.random(n) < 0.4).astype(np.uint8)
    vals = np.where(kinds == 1, rng.integers(3, 259, n),
                    rng.integers(0, 256, n)).astype(np.int32)
    offs = np.where(kinds == 1, rng.integers(1, 32769, n), 0).astype(np.int32)
    return kinds, vals, offs


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 40), (2, 2000), (3, 20000)])
def test_block_codes_and_costs_equal(seed, n):
    rng = np.random.default_rng(200 + seed)
    kinds, vals, offs = _items(rng, n)
    assert _same(emit.item_symbols(kinds, vals, offs),
                 jemit.item_symbols(kinds, vals, offs))
    lf, of = emit.block_histograms(kinds, vals, offs)
    assert _same((lf, of), jemit.block_histograms(kinds, vals, offs))
    mine, theirs = emit.BlockCodes(lf, of), jemit.BlockCodes(lf, of)
    for attr in ("litlen_lens", "litlen_codes", "off_lens", "off_codes",
                 "num_litlen", "num_offsets", "pre_syms", "pre_xv", "pre_xb",
                 "pre_lens", "pre_codes", "num_explicit_pre"):
        assert _same(getattr(mine, attr), getattr(theirs, attr)), attr
    assert mine.header_cost_bits() == theirs.header_cost_bits()
    extra = (int(rng.integers(0, 10000)), int(rng.integers(0, 10000)))
    assert mine.body_cost_bits(lf, of, *extra) == \
        theirs.body_cost_bits(lf, of, *extra)
    assert emit.static_cost_bits(lf, of, *extra) == \
        jemit.static_cost_bits(lf, of, *extra)
    for nbytes, bitcount in ((0, 0), (1, 3), (65535, 7), (65536, 5),
                             (200000, 13)):
        assert emit.stored_cost_bits(nbytes, bitcount) == \
            jemit.stored_cost_bits(nbytes, bitcount)


def _write(mod, fn):
    w = mod.BitWriter()
    w.add(5, 3)
    fn(mod, w)
    assert w.bit_length() >= 3
    return w.finish()


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 70000), (2, 300)])
def test_emit_stored_and_blocks_equal(seed, n):
    rng = np.random.default_rng(300 + seed)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    # stored blocks: empty, one segment, more than 65535 bytes
    for final in (False, True):
        assert _write(emit, lambda m, w: m.emit_stored(w, data, final)) == \
            _write(jemit, lambda m, w: m.emit_stored(w, data, final))
    kinds, vals, offs = _items(rng, max(n // 10, 1))

    def blocks(m, w):
        m.emit_items(w, kinds, vals, offs, m.STATIC_LITLEN_LENS,
                     m.STATIC_LITLEN_CODES, m.STATIC_OFFSET_LENS,
                     m.STATIC_OFFSET_CODES)
        m.flush_block(w, data, kinds, vals, offs, is_final=False)
        # all literals: flush_block picks among stored, static and dynamic
        lits = np.zeros(len(data), np.uint8)
        m.flush_block(w, data, lits, np.frombuffer(data, np.uint8)
                      .astype(np.int32), np.zeros(len(data), np.int32), True)
    assert _write(emit, blocks) == _write(jemit, blocks)
    w, jw = emit.BitWriter(), jemit.BitWriter()
    words = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    for m in (w, jw):
        m.add(1, 1)
        m.add_words(words, 50 * 32 - 7)
    assert w.finish() == jw.finish()


def test_level_tables_equal():
    assert parse_host.LEVEL_PARAMS.keys() == jparse.LEVEL_PARAMS.keys()
    for lv, p in parse_host.LEVEL_PARAMS.items():
        assert vars(p) == vars(jparse.LEVEL_PARAMS[lv])
    assert parse_optimal.OPT_PARAMS == jopt.OPT_PARAMS
    assert parse_optimal.BIT_COST == jopt.BIT_COST
    for name in ("MULT", "HASH4_ORDER", "HASH3_ORDER", "WINDOW", "MAX_LEN"):
        assert getattr(parse_host, name) == getattr(jparse, name)
