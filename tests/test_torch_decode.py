"""The port's scalar DEFLATE decoder against the JAX package's, on the CPU.

libdeflate_tpu_torch/decompress/ against
libdeflate_tpu/decompress/pallas_decode.py run in interpret mode:
``decompress_chunks_words(..., device="cpu")`` against
``decompress_chunks_pallas(..., interpret=True)`` in known-size and
unknown-size mode, and ``decompress_chunks(..., device="cpu")`` against
``pallas_decode.decompress_chunks(..., interpret=True)``.  Cases: those of
tests/test_pallas_decode.py (block types, 32 KiB window and flush
crossings, deep-codeword subtables, the zlib-lax incomplete codes, a
corrupt stream, mixed sizes, a match at distance 32768), with this
repository's SURVEY.md and PERF_NOTES.md as the text; a seeded set of
damaged streams (bit flips, byte overwrites, truncations); blocks that
run on through the zero padding; stored blocks whose LEN passes the data;
known-size calls whose out_len is one off.
The decode tables are held against ``_build_table_scalar`` run in a small
interpret-mode Pallas kernel, the constants against the module's own.

Tolerance: exact.  status, out_lens and consumed must be equal for every
chunk, and out[:out_len] where status is 0 (past out_len the reference
leaves stale ring words; the port writes zeros, checked here too).  Few
batch shapes are used, since each costs seconds of interpret-mode compile.
"""

import struct
import zlib
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import libdeflate_tpu_torch as lt
from libdeflate_tpu.decompress import pallas_decode as pd
from libdeflate_tpu_torch.decompress import tables
from tests.test_incomplete_codes import craft_dynamic_stream

REPO = Path(__file__).resolve().parents[1]
TEXT = ((REPO / "SURVEY.md").read_bytes()
        + (REPO / "PERF_NOTES.md").read_bytes())
B, W, OUT_BYTES = 4, 12288, 81920        # the words-entry batch shape
N, OUT_CAP = 40960, 81920                # the bytes-entry batch shape
FILLER = b"\x03\x00"                     # an empty static final block


def _z(raw, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(raw) + c.flush()


def _pack_words(streams):
    comp = np.zeros((len(streams), W), np.uint32)
    clen = np.zeros(len(streams), np.int32)
    for k, s in enumerate(streams):
        pad = (-len(s)) % 4
        comp[k, : (len(s) + pad) // 4] = np.frombuffer(s + b"\0" * pad,
                                                       np.uint32)
        clen[k] = len(s)
    return comp, clen


def _check(name, want, got):
    """Compare (out, status, out_lens, consumed) of the reference and the
    port chunk by chunk; return the port's results as numpy arrays."""
    w_out, w_st, w_ol, w_cons = (np.asarray(x) for x in want)
    g_out, g_st, g_ol, g_cons = (x.numpy() for x in got)
    assert g_out.shape == w_out.shape and g_out.dtype == np.uint8
    for k in range(w_st.shape[0]):
        assert (g_st[k], g_ol[k], g_cons[k]) == (w_st[k], w_ol[k],
                                                 w_cons[k]), (name, k)
        if w_st[k] == 0:
            assert np.array_equal(g_out[k, :g_ol[k]], w_out[k, :w_ol[k]]), \
                (name, k)
        assert not g_out[k, g_ol[k]:].any(), (name, k)
    return g_out, g_st, g_ol, g_cons


def _both_words(streams, out_lens, known_size):
    """Both decoders on streams padded to the B x W words batch."""
    streams = list(streams) + [FILLER] * (B - len(streams))
    out_lens = np.asarray(list(out_lens) + [0] * (B - len(out_lens)),
                          np.int32)
    comp, clen = _pack_words(streams)
    want = pd.decompress_chunks_pallas(
        jnp.asarray(comp), jnp.asarray(clen), jnp.asarray(out_lens),
        OUT_BYTES, known_size=known_size, interpret=True)
    got = lt.decompress_chunks_words(comp, clen, out_lens, OUT_BYTES,
                                     known_size=known_size, device="cpu")
    return _check(f"words known_size={known_size}", want, got)


def _both_bytes(streams, n=N, out_cap=OUT_CAP):
    """Both unknown-size entries on streams in a [B, n] byte batch."""
    bufs = np.zeros((B, n), np.uint8)
    lens = np.zeros(B, np.int32)
    for k, s in enumerate(list(streams) + [FILLER] * (B - len(streams))):
        bufs[k, :len(s)] = np.frombuffer(s, np.uint8)
        lens[k] = len(s)
    w_out, w_ol, w_cons, w_st = pd.decompress_chunks(
        jnp.asarray(bufs), jnp.asarray(lens), out_cap, interpret=True)
    g_out, g_ol, g_cons, g_st = lt.decompress_chunks(bufs, lens, out_cap,
                                                     device="cpu")
    out, st, ol, cons = _check("bytes", (w_out, w_st, w_ol, w_cons),
                               (g_out, g_st, g_ol, g_cons))
    return out, st, ol, cons


def _roundtrip(streams, raws):
    """Known-size and unknown-size decode of valid streams: both decoders
    agree, and the port returns every chunk."""
    out, st, ol, _ = _both_words(streams, [len(r) for r in raws], True)
    for k, r in enumerate(raws):
        assert st[k] == 0 and ol[k] == len(r)
        assert out[k, :len(r)].tobytes() == r
    out, st, ol, _ = _both_words(streams, [OUT_BYTES] * len(raws), False)
    for k, r in enumerate(raws):
        assert st[k] == 0 and out[k, :ol[k]].tobytes() == r


# ---------------------------------------------------------------------------
# constants and tables
# ---------------------------------------------------------------------------
def test_constants_match_reference():
    for name in ("LEN_BASE", "LEN_EXTRA", "OFF_BASE", "OFF_EXTRA",
                 "PRECODE_PERM"):
        assert np.array_equal(getattr(tables, name), getattr(pd, name)), name
    assert np.array_equal(tables.STATIC_LENS, pd._STATIC_LENS)
    assert np.array_equal(tables.CONSTS, pd._CONSTS)
    assert (tables.C_LB, tables.C_LE, tables.C_OB, tables.C_OE, tables.C_PP,
            tables.C_SL) == (pd._C_LB, pd._C_LE, pd._C_OB, pd._C_OE,
                             pd._C_PP, pd._C_SL)
    assert (tables.LTB, tables.OTB, tables.PTB, tables.LL_SIZE,
            tables.OF_SIZE, tables.STAGE_W, tables.FLUSHB) == (
        pd.LTB, pd.OTB, pd.PTB, pd.LL_SIZE, pd.OF_SIZE, pd.STAGE_W,
        pd.FLUSHB)
    assert (tables.K_LIT, tables.K_BASE, tables.K_EOB, tables.K_SUB,
            tables.OK, tables.BAD_DATA) == (pd.K_LIT, pd.K_BASE, pd.K_EOB,
                                            pd.K_SUB, pd.OK, pd.BAD_DATA)


@pytest.mark.parametrize("role", [0, 1, 2])
def test_make_entry_matches_reference(role):
    nsym = {0: 19, 1: 288, 2: 32}[role]
    sym, length = np.meshgrid(np.arange(nsym), np.arange(1, 16))
    want = np.asarray(pd._make_entry(role, jnp.asarray(sym, jnp.int32),
                                     jnp.asarray(length, jnp.int32),
                                     jnp.asarray(pd._CONSTS)))
    got = np.vectorize(partial(tables.make_entry, role))(sym, length)
    assert np.array_equal(got, want.astype(np.int64) & 0xFFFFFFFF)


@partial(jax.jit, static_argnames=("role",))
def _reference_table(n, lens, role):
    """``_build_table_scalar`` in a one-step interpret-mode kernel:
    (table int32[size] with unfilled slots 0, ok)."""
    tb, size, enough = tables.ROLE_TABLE[role]

    def kernel(n_ref, consts_ref, lens_ref, tab_ref, ok_ref, aux):
        def zero(i, _):
            tab_ref[i] = 0
            return 0
        jax.lax.fori_loop(0, size, zero, 0)
        ok_ref[0] = pd._build_table_scalar(
            lens_ref, jnp.int32(0), n_ref[0], tb, tab_ref,
            jnp.int32(enough), role, aux, consts_ref)

    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return pl.pallas_call(
        kernel, in_specs=[smem] * 3, out_specs=[smem] * 2,
        out_shape=[jax.ShapeDtypeStruct((size,), jnp.int32),
                   jax.ShapeDtypeStruct((1,), jnp.int32)],
        scratch_shapes=[pltpu.SMEM((1184,), jnp.int32)],
        interpret=True)(n, jnp.asarray(pd._CONSTS), lens)


def _compare_table(lens, role):
    lens = np.asarray(lens, np.int32)
    padded = np.zeros(320, np.int32)
    padded[:lens.size] = lens
    want, ok = _reference_table(jnp.asarray([lens.size], jnp.int32),
                                jnp.asarray(padded), role)
    table, got_ok = tables.build_table(lens, role)
    assert got_ok == bool(ok[0])
    assert table == (np.asarray(want).astype(np.int64) & 0xFFFFFFFF).tolist()
    return table, got_ok


def _kraft_lengths(rng, nsym, max_len, nused):
    """Lengths of a complete code over nused random symbols: split the
    shortest leaf until there are nused leaves, lengths capped."""
    lens = [0]
    while len(lens) < nused:
        cand = [i for i, ln in enumerate(lens) if ln < max_len]
        i = min(cand, key=lambda j: (lens[j], rng.random()))
        if rng.random() < 0.3:
            i = cand[int(rng.integers(0, len(cand)))]
        lens[i] += 1
        lens.append(lens[i])
    out = np.zeros(nsym, np.int32)
    out[rng.choice(nsym, nused, replace=False)] = lens
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("role", [0, 1, 2])
def test_build_table_matches_reference(role, seed):
    rng = np.random.default_rng(100 + seed)
    nsym, max_len = {0: (19, 7), 1: (288, 15), 2: (30, 15)}[role]
    nused = int(rng.integers(2, nsym + 1))
    if seed == 0 and role > 0:
        lens = (tables.STATIC_LENS[:288] if role == 1
                else tables.STATIC_LENS[288:])
    else:
        lens = _kraft_lengths(rng, nsym, max_len, nused)
    table, ok = _compare_table(lens, role)
    assert ok


def test_build_table_deep_subtables_and_pairs():
    # two 2-bit literals (pairs), EOB, a length code, 16 8-bit symbols,
    # then codewords of 15 down to 9 bits (subtables) completing the code
    ll = np.zeros(288, np.int32)
    ll[[ord("a"), ord("b")]] = 2
    ll[256], ll[257] = 3, 4
    ll[258:274] = 8
    free = np.flatnonzero(ll == 0)
    deep = [15, 15, 14, 13, 12, 11, 10] + [9] * 127
    ll[free[:len(deep)]] = deep
    assert sum(1 << (15 - int(x)) for x in ll if x) == 1 << 15
    table, ok = _compare_table(ll, 1)
    assert ok and any((e >> 12) & 3 == tables.K_SUB for e in table[:2048])
    assert any(e & 0x4000 for e in table[:2048])


def test_build_table_empty_code():
    for role, nsym in ((0, 19), (1, 288), (2, 30)):
        table, ok = _compare_table(np.zeros(nsym, np.int32), role)
        tb = tables.ROLE_TABLE[role][0]
        assert ok and table[:1 << tb] == [tables.make_entry(role, 0, 1)] * (
            1 << tb)


def test_build_table_single_codeword():
    lens = np.zeros(288, np.int32)
    lens[256] = 1
    table, ok = _compare_table(lens, 1)
    eob = tables.make_entry(1, 256, 1)
    assert ok and table[:1 << tables.LTB] == [eob] * (1 << tables.LTB)
    lens = np.zeros(30, np.int32)
    lens[7] = 1
    table, ok = _compare_table(lens, 2)
    assert ok and set(table[:256]) == {tables.make_entry(2, 7, 1)}


def test_build_table_oversubscribed_code():
    lens = np.zeros(288, np.int32)
    lens[:3] = 1
    _, ok = _compare_table(lens, 1)
    assert not ok
    lens = np.zeros(19, np.int32)
    lens[:5] = 2
    _, ok = _compare_table(lens, 0)
    assert not ok


def test_build_table_incomplete_two_codewords_rejected():
    lens = np.zeros(288, np.int32)
    lens[[65, 256]] = 2
    _, ok = _compare_table(lens, 1)
    assert not ok


# ---------------------------------------------------------------------------
# the cases of tests/test_pallas_decode.py
# ---------------------------------------------------------------------------
def test_block_types_roundtrip():
    rng = np.random.default_rng(11)
    raw_dyn = (b"the quick brown fox jumps over the lazy dog. " * 8)[:256]
    raw_static = b"abcabcabcabc hello hello" * 4
    raw_stored = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    _roundtrip([_z(raw_dyn), _z(raw_static, strategy=zlib.Z_FIXED),
                _z(raw_stored, 0)], [raw_dyn, raw_static, raw_stored])


def test_window_and_flush_crossings():
    raw = (TEXT * 2)[:80000]
    raw2 = b"\x00" * 40000 + b"ab" * 1000
    _roundtrip([_z(raw), _z(raw2, 9)], [raw, raw2])


def test_deep_codewords_subtables():
    rng = np.random.default_rng(12)
    p = np.ones(256)
    p[:8] = 4000
    p /= p.sum()
    raw = rng.choice(np.arange(256, dtype=np.uint8), size=40000,
                     p=p).tobytes()
    _roundtrip([_z(raw, 9)], [raw])


def test_incomplete_code_acceptance():
    s1 = craft_dynamic_stream({ord("a"): 1, 256: 1}, {},
                              [("lit", ord("a"))] * 3 + [("eob",)])
    s2 = craft_dynamic_stream(
        {ord("x"): 1, 256: 2, 257: 2}, {0: 1},
        [("lit", ord("x")), ("match", 257, 0, 0, 0, 0, 0), ("eob",)])
    _roundtrip([s1, s2], [b"aaa", b"xxxx"])


def test_corrupt_stream_rejected():
    raw = (TEXT * 3)[:20000]
    s = bytearray(_z(raw))
    s[len(s) // 2] ^= 0xFF
    s[len(s) // 3] ^= 0x55
    _, st, _, _ = _both_words([bytes(s)], [len(raw)], True)
    assert st[0] != 0
    _both_words([bytes(s)], [len(raw)], False)


def test_batch_mixed_sizes():
    rng = np.random.default_rng(13)
    raws = [rng.integers(97, 110, n, dtype=np.uint8).tobytes()
            for n in (7, 1000, 33000)]
    _roundtrip([_z(r) for r in raws], raws)
    _both_bytes([_z(r) for r in raws])


def test_full_window_distance_match():
    from libdeflate_tpu import api

    rng = np.random.default_rng(7)
    head = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    gap = rng.integers(0, 256, 32768 - 256, dtype=np.uint8).tobytes()
    raw = head + gap + head + rng.integers(0, 256, 512,
                                           dtype=np.uint8).tobytes()
    streams = [bytes(api.Compressor(level).deflate_compress(raw))
               for level in (6, 9, 12)]
    _roundtrip(streams, [raw] * 3)


# ---------------------------------------------------------------------------
# damaged streams, stored LEN past the data, out_len one off
# ---------------------------------------------------------------------------
def _damaged(seed):
    """Four damaged streams of one valid stream of in-repo text: bit flips,
    a byte overwrite, truncations.  Returns (streams, raw)."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(2000, 30000))
    off = int(rng.integers(0, len(TEXT) - n))
    raw = TEXT[off:off + n]
    s = _z(raw, int(rng.choice([1, 6, 9])),
           zlib.Z_FIXED if seed % 4 == 3 else zlib.Z_DEFAULT_STRATEGY)
    out = []
    for kind in range(4):
        b = bytearray(s)
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, 8 * len(b)))
                b[i // 8] ^= 1 << (i % 8)
        elif kind == 1:
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 2:
            b = b[:int(rng.integers(1, len(b)))]
        else:
            b = b[:len(b) - int(rng.integers(1, 4))]
        out.append(bytes(b))
    return out, raw


@pytest.mark.parametrize("seed", range(8))
def test_damaged_streams(seed):
    streams, raw = _damaged(seed)
    _both_words(streams, [len(raw)] * len(streams), True)
    _both_words(streams, [len(raw)] * len(streams), False)
    _both_bytes(streams)


@pytest.mark.parametrize("bits", [1, 3])
def test_run_on_through_zero_padding(bits):
    """Blocks without EOB whose all-zero codeword is a literal: decoding
    runs on through the padding until the guard, out_len or the 32 KiB
    boundary stops it, so where it stops depends on the staging base, the
    burst budget and the guard (1-bit codes are paired, 3-bit ones too)."""
    syms = "a" if bits == 1 else "bcdefgh"
    lens = {ord(ch): bits for ch in syms} | {256: bits}
    streams = [craft_dynamic_stream(lens, {}, [("lit", ord(syms[-1]))] * n)
               for n in (1, 106, 113, 4000)]
    _both_words(streams, [OUT_BYTES] * 4, False)
    _both_words(streams, [70001, 69632, OUT_BYTES, 66000], True)


def _stored(length, data):
    return bytes([1]) + struct.pack("<HH", length, length ^ 0xFFFF) + data


def test_stored_len_past_the_data():
    """LEN past the 100 data bytes: accepted while the zero padding
    covers it, BAD once the copy reaches byte 4 * W_pad - 8 of the padded
    row (here W_pad = 5120 words: 4096 + 8 * STAGE_W bytes)."""
    data = bytes(range(100))
    streams = [_stored(5000, data), _stored(60000, data)]
    _, st, ol, cons = _both_bytes(streams, n=4096, out_cap=65536)
    assert (st[0], ol[0], cons[0]) == (0, 5000, 105)
    assert (st[1], ol[1], cons[1]) == (1, 20480 - 8 - 5, 105)


def test_known_size_out_len_one_off():
    raw = (TEXT * 2)[5000:25000]
    s = _z(raw)
    _, st, ol, _ = _both_words([s, s, s], [len(raw) - 1, len(raw) + 1,
                                           len(raw)], True)
    assert list(st[:3]) == [1, 1, 0]
    assert ol[1] == ol[2] == len(raw)
