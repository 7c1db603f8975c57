"""The port's tokenize-only kernel (K4) against the JAX package's, on the CPU.

libdeflate_tpu_torch/experiments/exp_tokenize_ceiling.py::tokenize_chunks
(device="cpu", so its plain version) against
scripts/exp_tokenize_ceiling.py::tokenize_chunks run in interpret mode, for
unroll 1 and 4 and for store_tokens on (the configurations give the same
outputs).  Inputs: zlib level-6 text (this repository's SURVEY.md and
PERF_NOTES.md), a Z_FIXED stream, stored blocks, deep-codeword subtables, the
zlib-lax incomplete codes (tests/test_incomplete_codes.craft_dynamic_stream),
seeded damaged streams (bit flips, a byte overwrite, truncations), blocks
that run on through the zero padding, out_len one off, and stored blocks
whose LEN passes the data or the padded row (where the reference reads past
its row, the port's choice is pinned to what interpret mode gives).

Tolerance: exact in status, op and acc (acc compared modulo 2**32, as the
bit pattern of an int32).  One batch shape (B = 2, W = 12288 words) is used,
since each interpret-mode shape and configuration costs seconds of compile.
"""

import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk
from scripts import exp_tokenize_ceiling as ref
from tests.test_incomplete_codes import craft_dynamic_stream

REPO = Path(__file__).resolve().parents[1]
TEXT = ((REPO / "SURVEY.md").read_bytes()
        + (REPO / "PERF_NOTES.md").read_bytes())
B, W = 2, 12288
FILLER = b"\x03\x00"                     # an empty static final block
CFGS = [(1, False), (4, False), (1, True)]


def _z(raw, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(raw) + c.flush()


def _stored(length, data, final=True):
    return bytes([int(final)]) + struct.pack("<HH", length,
                                             length ^ 0xFFFF) + data


def _both(streams, out_lens, cfg):
    """Both versions on streams padded to the B x W batch; returns the
    port's (status, op, acc) as numpy arrays."""
    streams = list(streams) + [FILLER] * (B - len(streams))
    out_lens = np.asarray(list(out_lens) + [0] * (B - len(out_lens)),
                          np.int32)
    comp = np.zeros((B, W), np.uint32)
    clen = np.zeros(B, np.int32)
    for k, s in enumerate(streams):
        comp[k, : -(-len(s) // 4)] = np.frombuffer(s + b"\0" * (-len(s) % 4),
                                                   np.uint32)
        clen[k] = len(s)
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


def _deep_stream():
    """A crafted dynamic block whose litlen code reaches 15 bits and whose
    offset code reaches 11 (subtables in both tables), with paired 2-bit
    literals, 78 bytes of output."""
    ll = np.zeros(288, np.int64)
    ll[[ord("a"), ord("b")]] = 2
    ll[256], ll[257] = 3, 4
    ll[258:274] = 8
    free = np.flatnonzero(ll == 0)
    deep = [15, 15, 14, 13, 12, 11, 10] + [9] * 127
    ll[free[:len(deep)]] = deep
    of = {k: k + 1 for k in range(11)} | {11: 11}
    lits = [("lit", s) for s in (ord("a"), ord("b"), *free[:7], ord("a"))]
    body = lits * 6 + [("match", 257, 0, 0, 0, 0, 0),      # 3 at 1
                       ("match", 258, 0, 0, 11, 4, 3),     # 4 at 52
                       ("match", 260, 0, 0, 10, 4, 5),     # 6 at 38
                       ("match", 259, 0, 0, 9, 3, 2),      # 5 at 27
                       ("eob",)]
    lens = {int(s): int(n) for s, n in enumerate(ll) if n}
    return craft_dynamic_stream(lens, of, body)


@pytest.mark.parametrize("cfg", CFGS)
def test_crafted_deep_subtables(cfg):
    s = _deep_stream()
    assert len(zlib.decompress(s, -15)) == 78
    st, op, _ = _both([s, s], [78, 77], cfg)
    assert list(st) == [0, 1] and op[0] == 78


@pytest.mark.parametrize("cfg", CFGS)
def test_incomplete_codes(cfg):
    s1 = craft_dynamic_stream({ord("a"): 1, 256: 1}, {},
                              [("lit", ord("a"))] * 3 + [("eob",)])
    s2 = craft_dynamic_stream(
        {ord("x"): 1, 256: 2, 257: 2}, {0: 1},
        [("lit", ord("x")), ("match", 257, 0, 0, 0, 0, 0), ("eob",)])
    st, op, _ = _both([s1, s2], [3, 4], cfg)
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
    syms = "a" if bits == 1 else "bcdefgh"
    lens = {ord(ch): bits for ch in syms} | {256: bits}
    streams = [craft_dynamic_stream(lens, {}, [("lit", ord(syms[-1]))] * n)
               for n in (1, 106, 113, 4000)]
    _both(streams[:2], [81920, 69632], cfg)
    _both(streams[2:], [70001, 1 << 20], cfg)


@pytest.mark.parametrize("cfg", CFGS)
def test_out_len_one_off(cfg):
    raw = (TEXT * 2)[5000:25000]
    s = _z(raw)
    st, op, _ = _both([s, s], [len(raw) - 1, len(raw) + 1], cfg)
    assert list(st) == [1, 0] and op[1] == len(raw)


@pytest.mark.parametrize("cfg", CFGS)
def test_stored_len_past_the_data(cfg):
    """A stored block is one token: LEN past the 100 data bytes is
    accepted (no staging bound), the cursor jumping past the data."""
    data = bytes(range(100))
    st, op, acc = _both([_stored(5000, data), _stored(60000, data)],
                        [65536, 65536], cfg)
    assert list(st) == [0, 0] and list(op) == [5000, 60000]
    assert list(acc) == [5000, 60000]


@pytest.mark.parametrize("cfg", CFGS)
def test_stored_len_past_the_padded_row(cfg):
    """A non-final stored block whose LEN jumps the cursor past the padded
    row (4 * W bytes): the next header lies past the row.  Interpret mode
    reads the row's last word there (a zero stored header: BAD); the port
    calls a header past the row BAD.  Both keep op and acc."""
    data = bytes(range(100))
    st, op, acc = _both([_stored(60000, data, False),
                         _stored(40000, data, False)], [65536, 65536], cfg)
    assert list(st) == [1, 1] and list(op) == [60000, 40000]


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
