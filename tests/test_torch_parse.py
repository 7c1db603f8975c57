"""The port's greedy/lazy parser against the JAX package's.

libdeflate_tpu_torch/compress/pipeline.py, with chain_kernels.py's plain
doublings, against
libdeflate_tpu/compress/tpu_pipeline.py: _sorted_matchfind (the packed
best-of-depth path and the wide_ext A/B path, 16- and 8-byte payloads, 64
and 128 KiB segments), _chain_extend, _chain_extend2, _hash3_matchfind
and _parse_chunk in the configurations of the static tier and of dyn1,
dyn2 and dyn3.  The JAX functions take one chunk and run under vmap.

Inputs, made with numpy from fixed seeds: a batch of two 64 KiB chunks,
this repository's SURVEY.md text and random letters of an 8-letter
alphabet (which raises the adaptive minimum match length), at live
lengths 511, 512, 513, 4095, 40000, 65535 and 65536; the 128 KiB segments
run on the same two chunks as one row.  Tolerance: exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import bits, chain_kernels
from libdeflate_tpu_torch.compress import pipeline as pp

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite may run its
    files in parallel workers, and torch's OpenMP regions on [B, 64 KiB]
    tensors slow down by orders of magnitude when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def batch():
    raw = (REPO / "SURVEY.md").read_bytes()
    text = np.frombuffer((raw * (N // len(raw) + 1))[:N], np.uint8)
    rng = np.random.default_rng(8)
    letters = np.frombuffer(b"abcdefgh", np.uint8)[rng.integers(0, 8, N)]
    return np.stack([text, letters])


def words_and_hash(bufs, lengths):
    """The parser's inputs to the matchfind, from the port's own stages:
    le32 words, w4/w8/w12 and the hash with its junk bucket, [B, n]."""
    bt = torch.from_numpy(bufs.copy())
    w = bits.le32_words(bt)
    pos = torch.arange(bufs.shape[1])[None]
    h = ((w * bits.MULT) & pp.M32) >> (32 - bits.HASH_ORDER)
    junk = bits.seg_key_params(bufs.shape[1])[1]
    h = torch.where(pos + bits.MIN_MATCH <= torch.tensor(lengths)[:, None],
                    h, junk)
    return h, w, bits.ahead(w, 4), bits.ahead(w, 8), bits.ahead(w, 12)


def as_jax(x):
    return jnp.asarray(x.numpy().astype(np.uint32))


def assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype)), name


# (seg, depth, lcp, wide_ext): the static tier's main pass, dyn1's, dyn2's,
# dyn3's, the rescue pass, and the A/B path with 8-byte payloads
MATCHFIND = [(N, 2, 16, False), (2 * N, 6, 16, False), (N, 6, 16, True),
             (N, 12, 16, True), (N, 2, 8, False), (2 * N, 6, 8, True)]


@pytest.mark.parametrize("seg, depth, lcp, wide_ext", MATCHFIND)
def test_sorted_matchfind(seg, depth, lcp, wide_ext):
    bufs = batch()
    lengths = [N, 40000]
    if seg > N:          # one row of both chunks: 17-bit local positions
        bufs, lengths = bufs.reshape(1, 2 * N), [2 * N - 1]
    h, w, w4, w8, w12 = words_and_hash(bufs, lengths)
    if lcp == 8:
        w8 = w12 = None
    got = pp.sorted_matchfind(h, w, w4, w8, w12, seg, depth, wide_ext)
    fn = jax.jit(jax.vmap(functools.partial(
        tp._sorted_matchfind, seg=seg, depth=depth, wide_ext=wide_ext),
        in_axes=(0, 0, 0, None if w8 is None else 0,
                 None if w12 is None else 0)))
    want = fn(as_jax(h), as_jax(w), as_jax(w4),
              None if w8 is None else as_jax(w8),
              None if w12 is None else as_jax(w12))
    assert_same(got, want, ["len", "dist"])
    assert int((got[0] >= 4).sum()) > 1000


def chain_inputs(seed):
    """Word-granular triples with lengths 0-16 in steps of 4 and few
    distances, so that chains of equal distances splice at every stride."""
    rng = np.random.default_rng(seed)
    shape = (2, N)
    mlen = 4 * rng.integers(0, 5, shape)
    mlen[:, 1000:3000] = 8          # long runs that double to 258
    dist = rng.choice([1, 2, 3, 7, 300], shape)
    dist[:, 1000:3000] = 3
    fine = rng.integers(0, 4, shape)
    return [torch.from_numpy(x) for x in (mlen, dist, fine)]


def test_chain_extend():
    m, d, f = chain_inputs(1)
    want = jax.vmap(tp._chain_extend)(*(jnp.asarray(x.numpy(), jnp.int32)
                                        for x in (m, d, f)))
    got = chain_kernels.chain_extend_plain(m, d, f)
    assert_same(got, want, ["len", "dist"])
    assert int(got[0].max()) == bits.MAX_LEN


def test_chain_extend2():
    a, b = chain_inputs(2), chain_inputs(3)
    want = jax.vmap(tp._chain_extend2)(*(jnp.asarray(x.numpy(), jnp.int32)
                                         for x in a + b))
    got = chain_kernels.chain_extend2_plain(*a, *b)
    assert_same(got, want, ["len", "dist"])
    assert bool((got[1] == b[1]).any() & (got[1] != a[1]).any())


@pytest.mark.parametrize("seg", [N, 2 * N])
def test_hash3_matchfind(seg):
    bufs, lengths = batch(), [N, 4095]
    if seg > N:
        bufs, lengths = bufs.reshape(1, 2 * N), [2 * N]
    _, w, _, _, _ = words_and_hash(bufs, lengths)
    pos = torch.arange(bufs.shape[1])[None]
    h3 = (((w & 0xFFFFFF) * bits.MULT) & pp.M32) >> (32 - bits.HASH_ORDER)
    h3 = torch.where(pos + 3 <= torch.tensor(lengths)[:, None], h3,
                     bits.seg_key_params(seg)[1])
    want = jax.vmap(functools.partial(tp._hash3_matchfind, seg=seg))(
        as_jax(h3), as_jax(w))
    got = pp.hash3_matchfind(h3, w, seg)
    assert_same([got], [want], ["d3"])
    assert int((got > 0).sum()) > 1000


# the four tiers' parser configurations (tpu_pipeline.compress_chunk_static
# and tpu_dynamic.compress_chunk_dynamic{,2,3})
TIERS = {
    "static": {},
    "dyn1": dict(lazy=True, depth=6, wide_window=True),
    "dyn2": dict(lazy=True, two_pass=True, depth=6, wide_ext=True),
    "dyn3": dict(lazy=True, two_pass=True, depth=12, hash3=True,
                 wide_ext=True),
}
LENGTHS = [(N, 65535), (511, 513), (512, 4095)]


@functools.lru_cache(maxsize=None)
def jax_parse(tier):
    return jax.jit(jax.vmap(functools.partial(tp._parse_chunk,
                                              **TIERS[tier])))


@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
@pytest.mark.parametrize("tier", list(TIERS))
def test_parse_chunk(tier, lengths):
    bufs = batch()
    want = jax_parse(tier)(jnp.asarray(bufs),
                           jnp.asarray(lengths, jnp.int32))
    got = pp.parse_chunk(torch.from_numpy(bufs.copy()),
                         torch.tensor(lengths), **TIERS[tier])
    got = [got[0], got[1][0]] + list(got[2:])
    assert_same(got, [want[0], want[1][0]] + list(want[2:]),
                "bp pos commit_match commit_lit eff dist".split())
    assert bool(got[2].any())


def test_min_match_len_counts_only_live_bytes():
    bufs = batch()
    got = pp.min_match_len(torch.from_numpy(bufs.copy()),
                           torch.tensor([[N], [N]]))
    # text uses more than 44 byte values; 8 letters give 8
    assert got[:, 0].tolist() == [bits.MIN_MATCH, 7]
    short = pp.min_match_len(torch.from_numpy(bufs.copy()),
                             torch.tensor([[0], [3]]))
    assert short[:, 0].tolist() == [9, 9]
