"""The FSM decoder's root tables (F1, ``csrc/fsm_decode.cu``) against the
15-length compare, on the CPU.

``decompress/fsm.py`` mirrors the kernel's root-table build
(``root_table``) and its lookup with the compare as fallback
(``root_lookup``).  For every table here, at each root width the kernel
uses (11 litlen, 10 offsets, 7 precode), the mirror's lookup of each of
the 32 768 15-bit windows must give ``_decode_sym``'s symbol, length and
ok, and the base and extra bits of the symbol's length or offset slot;
the root must hold an entry exactly where the compare's length is at most
the root width, and the litlen root a pair of literals exactly where the
compare decodes a literal shorter than the root and the window's rest a
literal that fits it.  The tables: the static codes, every table the plain
decoder builds for the dynamic headers of ``experiments/fsm_cases.py``,
and hypothesis-drawn codes that are complete, incomplete with one
codeword (patched), empty (patched), incomplete otherwise and overfull
(both not ok).

Tolerance: exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from libdeflate_tpu_torch.decompress import fsm
from libdeflate_tpu_torch.experiments import crafted_streams as cs
from libdeflate_tpu_torch.experiments import fsm_cases as fc
from libdeflate_tpu_torch.formats.deflate import (
    LENGTH_SLOT_BASE,
    LENGTH_SLOT_EXTRA,
    OFFSET_SLOT_BASE,
    OFFSET_SLOT_EXTRA,
)

WINDOWS = np.arange(1 << 15)
SETS = fc.sets(cs.repo_text())


def _compare(tab):
    """_decode_sym of every 15-bit window: (sym, len, ok) arrays."""
    rows = [fsm._decode_sym(tab, w) for w in range(1 << 15)]
    return tuple(np.array(col) for col in zip(*rows))


def _hold(tab):
    """The mirror's lookup equals the compare on every window, at every
    role's root width."""
    sym, ln, ok = _compare(tab)
    for role, R in fsm.ROOT_BITS.items():
        root = fsm.root_table(tab, role)
        assert root.shape == (1 << R,) and root.dtype == np.uint32
        e, got_ok = fsm.root_lookup(tab, role, root, WINDOWS)
        e = e.astype(np.int64)
        assert np.array_equal(e & 15, ln), role
        assert np.array_equal((e >> 4) & 511, sym), role
        assert np.array_equal(got_ok, ok), role
        hit = (root[WINDOWS & ((1 << R) - 1)] & 15) != 0
        assert np.array_equal(hit, ok & (ln <= R)), role
        if role == "litlen":
            _hold_pairs(root, sym, ln, ok)
        xb, base = (e >> 13) & 15, e >> 17
        if role == "litlen":
            is_len = (sym >= 257) & (sym <= 285)
            s = np.clip(sym - 257, 0, 28)
            want_xb = np.where(is_len, LENGTH_SLOT_EXTRA[s], 0)
            want_base = np.where(is_len, LENGTH_SLOT_BASE[s], 0)
        elif role == "offset":
            s = np.minimum(sym, 29)
            want_xb, want_base = OFFSET_SLOT_EXTRA[s], OFFSET_SLOT_BASE[s]
        else:
            want_xb = want_base = np.zeros_like(sym)
        assert np.array_equal(xb, want_xb) and np.array_equal(base,
                                                              want_base)


def _hold_pairs(root, sym, ln, ok):
    """A litlen root entry is a pair exactly where its window's first
    symbol is a literal shorter than the root and the window's rest
    decodes to a literal that fits it; then it holds both."""
    R = fsm.ROOT_BITS["litlen"]
    w = np.arange(1 << R)
    e = root.astype(np.int64)
    rest = w >> np.where(ok[w], ln[w], 0)
    want = ok[w] & (sym[w] < 256) & (ln[w] < R) & ok[rest] \
        & (sym[rest] < 256) & (ln[w] + ln[rest] <= R)
    pair = ((e >> fsm.PAIR_BIT) & 1) == 1
    assert np.array_equal(pair, want)
    assert np.array_equal((e[pair] >> 13) & 15, ln[w][pair])
    assert np.array_equal((e[pair] >> 4) & 255, sym[w][pair])
    assert np.array_equal(e[pair] & 15, ln[w][pair] + ln[rest][pair])
    assert np.array_equal((e[pair] >> 17) & 255, sym[rest][pair])
    assert not (e[pair] >> (fsm.PAIR_BIT + 1)).any()


def test_root_widths_are_the_kernels():
    src = (cs.REPO / "libdeflate_tpu_torch" / "csrc" /
           "fsm_decode.cu").read_text()
    want = fsm.ROOT_BITS
    assert (f"constexpr int kLLR = {want['litlen']}, kOFR = "
            f"{want['offset']}, kPreR = {want['precode']};") in src
    assert f"constexpr int kPairBit = {fsm.PAIR_BIT};" in src


def test_static_codes():
    _hold(fsm._ST_LL)
    _hold(fsm._ST_OF)


def _tables_of(cases, monkeypatch):
    """Every distinct table the plain decoder builds on the cases, with
    whether it was ok."""
    seen = {}
    canon = fsm._canon_tables

    def spy(lens, nsyms):
        ok, tab = canon(lens, nsyms)
        key = (tuple(tab.count), tuple(tab.first_code), tuple(tab.sorted_syms))
        seen.setdefault(key, (ok, tab))
        return ok, tab

    monkeypatch.setattr(fsm, "_canon_tables", spy)
    for bufs, lens, _ in fc.batches(cases):
        fsm.decode_chunks_fsm_plain(torch.as_tensor(bufs),
                                    torch.as_tensor(lens), fc.OUT)
    return list(seen.values())


@pytest.mark.parametrize("name", list(SETS))
def test_dynamic_headers_of_the_case_sets(name, monkeypatch):
    tables = _tables_of(SETS[name], monkeypatch)
    if name in ("incomplete", "traps"):   # rejected codes among them
        assert {ok for ok, _ in tables} == {True, False}, name
    for _, tab in tables:
        _hold(tab)


def _lengths(kind: str, nsyms: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lens = np.zeros(nsyms, np.int64)
    if kind == "empty":
        return lens
    if kind == "single":
        lens[int(rng.integers(0, nsyms))] = 1
        return lens
    freq = rng.integers(0, 1000, nsyms) * (rng.random(nsyms) < 0.7)
    freq[rng.choice(nsyms, 3, replace=False)] += 1  # three symbols or more
    lens = cs.package_merge_lengths(freq, 7 if nsyms == 19 else 15)
    if kind == "gap":                  # incomplete, two codewords or more
        k = int(np.argmax(lens))
        lens[k] = lens[k] + 1 if lens[k] < 15 else 0
    elif kind == "over":               # overfull
        lens[np.flatnonzero(lens)[:3]] = 1
    return lens


@settings(max_examples=25, deadline=None, derandomize=True)
@given(kind=st.sampled_from(["complete", "single", "empty", "gap", "over"]),
       nsyms=st.sampled_from([19, 30, 32, 257, 286, 288]),
       seed=st.integers(0, 2**32 - 1))
def test_drawn_codes(kind, nsyms, seed):
    lens = _lengths(kind, nsyms, seed)
    pad = np.zeros(fsm.MAXSYMS, np.int64)
    pad[:nsyms] = lens
    ok, tab = fsm._canon_tables(pad.tolist(), nsyms)
    kraft = np.sum(2.0 ** -lens[lens > 0])
    if kind in ("complete", "single", "empty"):
        assert ok, (kind, kraft)
    else:
        assert not ok and kraft != 1, (kind, kraft)
    _hold(tab)
