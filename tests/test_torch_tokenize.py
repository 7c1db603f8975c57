"""The port's tokenize-only kernel (K4) against the JAX package's, on the CPU.

libdeflate_tpu_torch/experiments/exp_tokenize_ceiling.py::tokenize_chunks
(device="cpu", so its plain version) against
scripts/exp_tokenize_ceiling.py::tokenize_chunks run in interpret mode, for
unroll 1 and 4 and for store_tokens on (the configurations give the same
outputs).  Inputs: zlib level-6 text (this repository's SURVEY.md and
PERF_NOTES.md), a Z_FIXED stream, seeded damaged streams (bit flips, a byte
overwrite, truncations), blocks that run on through the zero padding, and
the crafted sets of libdeflate_tpu_torch/experiments/crafted_streams.py,
which chip_smoke.py also runs on the card: stored blocks whose LEN passes
the data or the padded row (where the reference reads past its row, the
port's choice is pinned to what interpret mode gives) or lands at a
staging-window or ring-segment edge, deep-codeword subtables, the zlib-lax
incomplete codes, out_len one off, literal bursts across staging-base
moves, and run-on blocks that read the row's last word and past it.  The
crafter there is held byte-equal to tests/test_incomplete_codes's.

Tolerance: exact in status, op and acc (acc compared modulo 2**32, as the
bit pattern of an int32).  One batch shape (B = 2, W = 12288 words) is used,
since each interpret-mode shape and configuration costs seconds of compile.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu_torch.experiments import crafted_streams as cs
from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk
from scripts import exp_tokenize_ceiling as ref
from tests import test_incomplete_codes as jax_crafter

TEXT = cs.repo_text()
B, W = cs.B, cs.W
CFGS = [(1, False), (4, False), (1, True)]
_z = cs.zlib_stream


def _both_rows(comp, clen, out_lens, cfg):
    """Both versions on one B x W batch; returns the port's (status, op,
    acc) as numpy arrays."""
    unroll, store = cfg
    want = ref.tokenize_chunks(jnp.asarray(comp), jnp.asarray(clen),
                               jnp.asarray(out_lens), unroll=unroll,
                               store_tokens=store, interpret=True)
    got = tk.tokenize_chunks(comp, clen, out_lens, unroll, store,
                             device="cpu")
    for name, w, g in zip(("status", "op", "acc"), want, got):
        assert g.dtype == torch.int32 and g.shape == (B,)
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, cfg)
    return tuple(g.numpy() for g in got)


def _both(streams, out_lens, cfg):
    """Both versions on streams padded to the B x W batch."""
    return _both_rows(*cs.pack_rows(streams, out_lens), cfg)


@pytest.mark.parametrize("cfg", CFGS)
def test_zlib_text_and_fixed(cfg):
    raw, raw2 = TEXT[:30000], TEXT[5000:25000]
    st, op, _ = _both([_z(raw), _z(raw2, 6, zlib.Z_FIXED)],
                      [len(raw), len(raw2)], cfg)
    assert list(st) == [0, 0] and list(op) == [len(raw), len(raw2)]


@pytest.mark.parametrize("cfg", CFGS)
def test_stored_and_deep_subtables(cfg):
    rng = np.random.default_rng(12)
    p = np.ones(256)
    p[:8] = 4000
    p /= p.sum()
    deep = rng.choice(np.arange(256, dtype=np.uint8), size=40000,
                      p=p).tobytes()
    stored = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    st, op, _ = _both([_z(stored, 0), _z(deep, 9)],
                      [len(stored), len(deep)], cfg)
    assert list(st) == [0, 0] and list(op) == [len(stored), len(deep)]


@pytest.mark.parametrize("cfg", CFGS)
def test_crafted_deep_subtables(cfg):
    assert len(zlib.decompress(cs.deep_stream(), -15)) == 78
    st, op, _ = _both_rows(*cs.deep_subtables(), cfg)
    assert list(st) == [0, 1] and op[0] == 78


@pytest.mark.parametrize("cfg", CFGS)
def test_incomplete_codes(cfg):
    st, op, _ = _both_rows(*cs.incomplete_codes(), cfg)
    assert list(st) == [0, 0] and list(op) == [3, 4]


def _damaged(seed):
    """Four damaged streams of one valid stream of in-repo text: bit flips,
    a byte overwrite, truncations.  Returns (streams, raw)."""
    rng = np.random.default_rng(2000 + seed)
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


@pytest.mark.parametrize("seed", range(6))
def test_damaged_streams(seed):
    streams, raw = _damaged(seed)
    cfg = CFGS[seed % len(CFGS)]
    _both(streams[:2], [len(raw)] * 2, cfg)
    _both(streams[2:], [len(raw), 40000], cfg)


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("bits", [1, 3])
def test_run_on_through_zero_padding(bits, cfg):
    """Blocks without EOB whose all-zero codeword is a literal: the token
    loop runs on through the padding until the guard or out_len stops it,
    so op depends on the staging base and the burst budget."""
    streams = [cs.run_on_stream(bits, n) for n in (1, 106, 113, 4000)]
    _both(streams[:2], [81920, 69632], cfg)
    _both(streams[2:], [70001, 1 << 20], cfg)


@pytest.mark.parametrize("cfg", CFGS)
def test_out_len_one_off(cfg):
    raw = (TEXT * 2)[5000:25000]
    st, op, _ = _both_rows(*cs.out_len_one_off(TEXT), cfg)
    assert list(st) == [1, 0] and op[1] == len(raw)


@pytest.mark.parametrize("cfg", CFGS)
def test_stored_len_past_the_data(cfg):
    """A stored block is one token: LEN past the 100 data bytes is
    accepted (no staging bound), the cursor jumping past the data."""
    st, op, acc = _both_rows(*cs.stored_past_the_data(), cfg)
    assert list(st) == [0, 0] and list(op) == [5000, 60000]
    assert list(acc) == [5000, 60000]


@pytest.mark.parametrize("cfg", CFGS)
def test_stored_len_past_the_padded_row(cfg):
    """A non-final stored block whose LEN jumps the cursor past the padded
    row (4 * W bytes): the next header lies past the row.  Interpret mode
    reads the row's last word there (a zero stored header: BAD); the port
    calls a header past the row BAD.  Both keep op and acc."""
    st, op, acc = _both_rows(*cs.stored_past_the_padded_row(), cfg)
    assert list(st) == [1, 1] and list(op) == [60000, 40000]


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("edge", ["window", "segment"])
def test_stored_jump_to_an_edge(edge, cfg):
    """A stored block's LEN puts the next header exactly at word 2048 (the
    first staging window's edge) and one byte after it, or at word 2560 (a
    512-word edge) and one byte before it; a Z_FIXED block follows."""
    rows = (cs.stored_to_the_window_edge(TEXT) if edge == "window" else
            cs.stored_to_a_segment_edge(TEXT))
    st, op, _ = _both_rows(*rows, cfg)
    assert list(st) == [0, 0] and np.array_equal(op, rows[2])


@pytest.mark.parametrize("cfg", CFGS)
def test_bursts_across_staging_moves(cfg):
    """Literal-only streams of ~40 KB: the bursts cross several moves of
    the staging base, and each budget ends inside a window."""
    comp, clen, olen = cs.bursts_across_staging_moves(TEXT)
    assert (clen > 38000).all() and (clen <= 4 * (W - 2048)).all()
    st, op, _ = _both_rows(comp, clen, olen, cfg)
    assert list(st) == [0, 0] and np.array_equal(op, olen)


@pytest.mark.parametrize("cfg", CFGS)
def test_run_on_into_the_last_word(cfg):
    """Run-on blocks that decode the zero padding up to word W_pad - 1,
    which holds set bits, and read past the row (where the port reads
    that word again): the 1-bit code's EOB is the word's top bit."""
    comp, clen, olen = cs.run_on_into_the_last_word()
    st, op, _ = _both_rows(comp, clen, olen, cfg)
    assert st[0] == 0 and op[0] > 40900 + 2000 * 32


def test_crafter_matches_the_jax_tests():
    """The port's crafter gives the JAX tests' crafter's bytes."""
    deep = cs.deep_stream()
    assert len(deep) > 100
    cases = [({ord("a"): 1, 256: 1}, {}, [("lit", ord("a"))] * 3
              + [("eob",)], True),
             ({ord("x"): 1, 256: 2, 257: 2}, {0: 1},
              [("lit", ord("x")), ("match", 257, 0, 0, 0, 0, 0), ("eob",)],
              False),
             ({ord(ch): 3 for ch in "bcdefgh"} | {256: 3}, {},
              [("lit", ord("h"))] * 113, True)]
    for ll, of, body, final in cases:
        assert cs.craft_dynamic_stream(ll, of, body, final) == \
            jax_crafter.craft_dynamic_stream(ll, of, body, final)
    for pm in ([0] * 19, [5] + [0] * 18, list(range(19))):
        assert np.array_equal(
            cs.package_merge_lengths(np.array(pm), 7),
            jax_crafter.package_merge_lengths(np.array(pm), 7))


def test_chain_counts():
    """The plain version's count of K4's chain: a stored block is one
    token and no lookup; each item adds its offset lookup; the counts
    leave the results alone."""
    rows = cs.stored_past_the_data()
    assert tk.chain_counts(*rows).tolist() == [[1, 1], [0, 0]]
    rows = cs.incomplete_codes()
    assert tk.chain_counts(*rows).tolist() == [[3, 3], [5, 5]]
    comp, clen, olen = cs.bursts_across_staging_moves(TEXT)
    tokens, lookups = tk.chain_counts(comp, clen, olen)
    assert (lookups > tokens).all() and (tokens <= olen).all()
    before = tk.tokenize_chunks(comp, clen, olen, device="cpu")
    tk.chain_counts(comp, clen, olen)
    after = tk.tokenize_chunks(comp, clen, olen, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tk.phase_cycles(comp, clen, olen)
        with pytest.raises(RuntimeError):
            tk.shared_load_latency()


def test_outside_the_input_contract():
    """Negative comp_len, or fewer than STAGE_W words of padding: BAD_DATA
    with op 0 and acc 0, without tokenizing (K3's choice)."""
    s = _z(TEXT[:20000])
    n = -(-len(s) // 4)
    comp = np.zeros((2, n + 2047), np.uint32)      # one word short
    comp[:, :n] = np.frombuffer(s + b"\0" * (-len(s) % 4), np.uint32)
    st, op, acc = tk.tokenize_chunks(comp, np.array([len(s), -1], np.int32),
                                     np.array([20000, 20000], np.int32),
                                     device="cpu")
    assert st.tolist() == [1, 1] and op.tolist() == [0, 0]
    assert acc.tolist() == [0, 0]


def test_wrapper_checks_and_launches_nothing_on_cpu():
    comp = np.zeros((2, W), np.uint32)
    args = (comp, np.array([2, 2], np.int32), np.array([0, 0], np.int32))
    tk.reset_launch_counts()
    for unroll, store in tk.CONFIGS.values():
        st, _, _ = tk.tokenize_chunks(*args, unroll, store, device="cpu")
        assert st.tolist() == [1, 1]      # a zero stored header: BAD
    assert tk.tokenize_chunks.launches == 0
    with pytest.raises(ValueError):
        tk.tokenize_chunks(*args, unroll=3, device="cpu")
    with pytest.raises(ValueError):
        tk.tokenize_chunks(*args, unroll=2, store_tokens=True, device="cpu")
    with pytest.raises(ValueError):
        tk.tokenize_chunks(comp[:, :100].copy(), *args[1:], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tk.tokenize_chunks(*args)
