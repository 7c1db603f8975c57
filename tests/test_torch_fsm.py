"""The port's FSM decoder (``libdeflate_tpu_torch/decompress/fsm.py``)
against the JAX package's ``libdeflate_tpu/decompress/tpu.py``.

Every batch has the shape of ``tests/test_tpu_decode.py`` (B = 8 rows of
N = 8192 bytes, out_cap 16384), so the JAX decoder compiles once.  The
plain version (what the wrapper runs for CPU tensors) must equal
``decompress_chunks`` in all four outputs, whole ``out`` rows included,
on the sets of ``experiments/fsm_cases.py`` (zlib levels and strategies,
the damaged set, the incomplete codes, one crafted case for each bound,
the edges of the kernel's root widths, input ring and window),
40 random blobs and a hypothesis property of random damage to random
zlib streams; ``experiments/fsm_pins.json`` (the pins ``chip_smoke.py``
holds the card to) must equal both.  The canonical table helpers equal
the JAX ones on complete, incomplete, overfull and empty codes.

Tolerance: exact.
"""

import functools
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import libdeflate_tpu_torch as lt
from libdeflate_tpu.decompress import tpu as dtpu
from libdeflate_tpu_torch.decompress import fsm
from libdeflate_tpu_torch.experiments import crafted_streams as cs
from libdeflate_tpu_torch.experiments import fsm_cases as fc

NAMES = ("out", "out_len", "consumed", "result")
TEXT = cs.repo_text()
SETS = fc.sets(TEXT)
PINS = cs.REPO / "libdeflate_tpu_torch" / "experiments" / "fsm_pins.json"


def _both(bufs, lens):
    """The port's four outputs, after checking them against JAX's."""
    want = [np.asarray(x) for x in dtpu.decompress_chunks(
        jnp.asarray(bufs), jnp.asarray(lens), fc.OUT)]
    got = [x.numpy() for x in fsm.decompress_chunks(bufs, lens, fc.OUT,
                                                    device="cpu")]
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), (name, np.flatnonzero(
            (g != w).reshape(len(g), -1).any(1)))
    return got


@functools.lru_cache(maxsize=None)
def _set_rows(name: str):
    """The pin rows of a set (each batch held to JAX first)."""
    rows = []
    for bufs, lens, n in fc.batches(SETS[name]):
        rows += fc.pin_rows(*_both(bufs, lens), n)
    return rows


@pytest.mark.parametrize("name", list(SETS))
def test_sets_equal_jax(name):
    rows = _set_rows(name)
    assert len(rows) == len(SETS[name])
    if name == "zlib":
        # every valid stream decodes to its source
        (bufs, lens, n), = fc.batches(SETS[name])
        out, ol, cons, res = fsm.decompress_chunks(bufs, lens, fc.OUT,
                                                   device="cpu")
        for k, (_, stream, n_in) in enumerate(SETS[name]):
            raw = zlib.decompressobj(-15).decompress(stream)
            assert int(res[k]) == 0 and int(cons[k]) == n_in <= fc.N
            assert out[k, :int(ol[k])].numpy().tobytes() == raw
    # each set holds failures and successes
    results = {r[3] for r in rows}
    assert results == ({0} if name in ("zlib", "edges") else {0, 1}
                       if name in ("damaged", "incomplete") else {0, 1, 3}), \
        results


def test_pins_equal_jax_and_the_plain_version():
    pins = json.loads(PINS.read_text())
    assert pins["shape"] == [fc.B, fc.N, fc.OUT]
    assert list(pins["sets"]) == list(fc.PINNED_SETS)
    for name in fc.PINNED_SETS:
        want = [[case[0]] + row for case, row in zip(SETS[name],
                                                     _set_rows(name))]
        assert pins["sets"][name] == want, name


def test_random_blobs():
    rng = np.random.default_rng(0x5EED)
    blobs = [rng.integers(0, 256, int(rng.integers(1, 65)),
                          np.uint8).tobytes() for _ in range(40)]
    for bufs, lens, _ in fc.batches([("", b, len(b)) for b in blobs]):
        _both(bufs, lens)


@settings(max_examples=6, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
def test_random_damage_of_random_zlib_streams(seed):
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(fc.B):
        kind = int(rng.integers(0, 3))
        n = int(rng.integers(0, 12000))
        if kind == 0:
            off = int(rng.integers(0, len(TEXT) - n))
            raw = TEXT[off:off + n]
        elif kind == 1:
            raw = rng.integers(0, 256, n // 3, np.uint8).tobytes()
        else:
            raw = rng.choice(np.frombuffer(b"aabbbcd\n", np.uint8),
                             n).tobytes()
        strategy = (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED,
                    zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE)[int(rng.integers(0, 4))]
        s = cs.zlib_stream(raw, int(rng.integers(0, 10)), strategy)
        streams.append(fc.damage([s], int(rng.integers(0, 1 << 30)))[
            int(rng.integers(0, 4))])
    # in_len the stream's length, or a few bytes off it
    cases = [("", s, len(s) + int(rng.choice([0, 0, -2, 3])))
             for s in streams]
    (bufs, lens, _), = fc.batches(cases)
    _both(bufs, lens)


def test_deflate_decompress_chunk_is_one_row():
    for name, s, n in SETS["traps"][:3] + SETS["zlib"][1:2]:
        row = np.zeros(fc.N, np.uint8)
        row[:len(s[:fc.N])] = np.frombuffer(s[:fc.N], np.uint8)
        want = [np.asarray(x) for x in dtpu.deflate_decompress_chunk(
            jnp.asarray(row), jnp.int32(n), fc.OUT)]
        got = [x.numpy() for x in lt.deflate_decompress_chunk(
            row, n, fc.OUT, device="cpu")]
        for key, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape and np.array_equal(g, w), (name, key)


def _length_arrays():
    """Code lengths of complete, zlib-lax incomplete, rejected incomplete,
    overfull and empty codes, at nsyms 19, 30, 32, 257 and 288."""
    rng = np.random.default_rng(5)
    out = []
    for nsyms in (19, 30, 32, 257, 288):
        freq = rng.integers(0, 50, nsyms)
        freq[rng.integers(0, nsyms, nsyms // 3)] = 0
        full = cs.package_merge_lengths(freq, 15 if nsyms > 19 else 7)
        one = np.zeros(nsyms, np.int64)
        one[int(rng.integers(0, nsyms))] = 1
        gap = full.copy()
        gap[np.flatnonzero(gap)[-1]] = 0
        over = full.copy()
        over[np.flatnonzero(over == 0)[:1]] = 1
        out += [(full, nsyms), (one, nsyms), (gap, nsyms), (over, nsyms),
                (np.zeros(nsyms, np.int64), nsyms)]
    # lengths past nsyms are masked
    out.append((cs.package_merge_lengths(rng.integers(1, 9, 288), 15), 260))
    return out


def test_canonical_tables_equal_jax():
    jcanon = jax.jit(dtpu._canon_tables)
    oks = set()
    for lens, nsyms in _length_arrays():
        pad = np.zeros(fsm.MAXSYMS, np.int32)
        pad[:len(lens)] = lens
        ok, c, fcode, fidx, syms = (np.asarray(x) for x in jcanon(
            jnp.asarray(pad), jnp.int32(nsyms)))
        pok, tab = fsm._canon_tables(pad.tolist(), nsyms)
        assert pok == bool(ok), (nsyms, lens)
        assert tab.count == c.tolist() and tab.first_code == fcode.tolist()
        assert tab.first_idx == fidx.tolist()
        assert tab.sorted_syms == syms.tolist()
        oks.add(pok)
    assert oks == {True, False}
    for lens in (fsm.STATIC_LITLEN_LENS, fsm.STATIC_OFFSET_LENS):
        want = [np.asarray(x).tolist() for x in dtpu._canon_host(lens)]
        tab = fsm._canon_host(lens)
        assert [tab.count, tab.first_code, tab.first_idx,
                tab.sorted_syms] == want


def test_entry_contract():
    bufs = np.zeros((2, 16), np.uint8)
    lens = np.zeros(2, np.int32)
    before = fsm.decompress_chunks.launches
    out, ol, cons, res = fsm.decompress_chunks(bufs, lens, 8, device="cpu")
    assert out.shape == (2, 8) and out.dtype == torch.uint8
    assert all(x.dtype == torch.int32 and x.shape == (2,)
               for x in (ol, cons, res))
    assert fsm.decompress_chunks.launches == before   # the CPU launches none
    with pytest.raises(ValueError):
        fsm.decompress_chunks(bufs[0], lens, 8, device="cpu")
    with pytest.raises(ValueError):
        fsm.decompress_chunks(bufs, lens[:1], 8, device="cpu")
    with pytest.raises(ValueError):
        fsm.decompress_chunks(bufs, lens, -1, device="cpu")
    with pytest.raises(ValueError):
        fsm.decompress_chunks(bufs, lens, fsm.MAX_BYTES + 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fsm.decompress_chunks(bufs, lens, 8)
        with pytest.raises(RuntimeError):
            lt.deflate_decompress_chunk(bufs[0], 0, 8)
