"""Shared cases of the DP-tier tests (tests/test_torch_optimal_*.py and
tests/test_torch_dp_candidates.py).

Each tier's port entry, its XLA counterpart in
``libdeflate_tpu/compress/tpu_optimal.py`` (or the mesh ladder's chunk
compressor, ``parallel/mesh.py::_chunk_compressor``) under vmap, and its
``_pallas`` twin in interpret mode, on one batch of two 64 KiB chunks
made with numpy from a fixed seed: this repository's SURVEY.md text
(65536 live bytes) beside 64-byte records with 5% noise (40000 live
bytes), bfinal mixed; the text chunk alone for B = 1; the two chunks cut
short (``small_batch``).  A test file takes
a few tiers, so that the suite's workers share the JAX compiles.  Also
the candidate generation of ``tpu_pipeline._parse_candidates`` in the
four configurations the entries use and with the options only
``scripts/`` uses.
"""

import functools
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu.parallel import mesh
from libdeflate_tpu_torch.compress import optimal as po
from libdeflate_tpu_torch.compress import pipeline

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16
BIAS = jnp.asarray(to._SHORT_BIAS16)
# tier -> (port entry, XLA per-chunk function, Pallas twin or None); the
# levels' port keywords are optimal.MESH_LEVEL_OPTIONS, held here to the
# mesh's own compressors
TIERS = {
    "optfast": (lt.compress_chunks_optfast,
                lambda b, l, f: to.compress_chunk_optimal(
                    b, l, f, passes=2, use_content=False, use_wide=False,
                    ladder=to.LEN_LADDER_DENSE2, ext_c=False, strides2=(),
                    match_bias16=BIAS),
                to.compress_chunks_optfast_pallas),
    "optimal": (lt.compress_chunks_optimal, to.compress_chunk_optimal,
                to.compress_chunks_optimal_pallas),
    "optimal2": (lt.compress_chunks_optimal2,
                 lambda b, l, f: to.compress_chunk_optimal(b, l, f,
                                                           passes=2),
                 to.compress_chunks_optimal2_pallas),
    "deep": (lt.compress_chunks_optimal_deep,
             lambda b, l, f: to.compress_chunk_optimal(
                 b, l, f, depth=12, two_pass=True, hash3=True, passes=3,
                 content_doublings=2, ladder=to.LEN_LADDER_DENSE2,
                 match_bias16=BIAS),
             to.compress_chunks_optimal_deep_pallas),
    **{f"level{k}": (functools.partial(lt.compress_chunks_optimal_with,
                                       **po.MESH_LEVEL_OPTIONS[k]),
                     mesh._chunk_compressor(k), None) for k in (5, 8, 10)},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a test file runs: the suite may run its
    files in parallel workers, and torch's OpenMP regions on [B, 64 KiB]
    tensors slow down by orders of magnitude when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def batch(b1=False):
    rng = np.random.default_rng(11)
    raw = (REPO / "SURVEY.md").read_bytes()
    text = np.frombuffer((raw * (N // len(raw) + 1))[:N], np.uint8)
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), N // 64)
    noise = rng.integers(0, 256, N, dtype=np.uint8)
    rec = np.where(rng.random(N) < 0.05, noise, rec).astype(np.uint8)
    if b1:
        return text[None], np.array([N], np.int32), np.array([True])
    return (np.stack([text, rec]), np.array([N, 40000], np.int32),
            np.array([True, False]))


def small_batch(n, lengths):
    """The batch's two chunks cut to ``n`` bytes, at ``lengths``."""
    bufs, _, bfinal = batch()
    return (bufs[:, :n].copy(), np.asarray(lengths, np.int32), bfinal)


@functools.lru_cache(maxsize=None)
def port(tier, b1=False, small=None):
    args = small_batch(*small) if small else batch(b1)
    return TIERS[tier][0](*args, device="cpu")


@functools.lru_cache(maxsize=None)
def xla(tier, small=None):
    args = small_batch(*small) if small else batch()
    out = jax.jit(jax.vmap(TIERS[tier][1]))(*(jnp.asarray(x) for x in args))
    return tuple(np.asarray(x) for x in out)


@functools.lru_cache(maxsize=None)
def pallas(tier, b1=True):
    out = TIERS[tier][2](*(jnp.asarray(x) for x in batch(b1)),
                         interpret=True)
    return tuple(np.asarray(x) for x in out)


def check(tier, b1, want, small=None):
    """The port's words and total_bits equal ``want``'s, and every
    fragment inflates to its chunk (``small``: ``small_batch``'s
    arguments)."""
    bufs, lengths, _ = small_batch(*small) if small else batch(b1)
    words, total_bits = port(tier, b1, small)
    assert np.array_equal(total_bits.numpy(), want[1])
    assert np.array_equal(words.numpy().view(np.uint32), want[0])
    for k in range(bufs.shape[0]):
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()


DEEP = dict(depth=12, two_pass=True, hash3=True, wide_window=False)
# _parse_candidates' configurations: lean, optfast and level 5-7; the
# defaults (optimal, optimal2, level 8-9); deep; level 10-12
CANDIDATES = {
    "lean": pipeline.LEAN_CANDIDATES,
    "defaults": {},
    "deep": dict(DEEP, content_doublings=2),
    "level10": DEEP,
}
CANDIDATE_LENGTHS = [(N, 40000), (511, 4095)]
# the options only scripts/ uses: 8- and 12-byte position-pass payloads
# on the lean and the default configurations, and the content pass's
# round probes after one and two doublings
OPTION_CANDIDATES = {
    "lean+lcp8": dict(pipeline.LEAN_CANDIDATES, lcp=8),
    "lean+lcp12": dict(pipeline.LEAN_CANDIDATES, lcp=12),
    "defaults+lcp8": dict(lcp=8),
    "round_probes1": dict(content_doublings=1, content_round_probes=True),
    "round_probes2": dict(content_doublings=2, content_round_probes=True),
}


def jax_candidates(config):
    """``_parse_candidates`` under vmap, run op by op: its arithmetic is
    integer only, so the eager ops give the jitted function's values, in
    a fifth of its compile time."""
    return jax.vmap(functools.partial(tp._parse_candidates,
                                      **{**CANDIDATES,
                                         **OPTION_CANDIDATES}[config]))


def check_candidates(config, lengths, one_row=False):
    """All nine outputs of ``parse_candidates`` equal
    ``_parse_candidates``' on the batch's chunks at ``lengths``, or with
    ``one_row`` on one 128 KiB row of a 20000-byte period of the text
    (two 64 KiB segments: the second's first 20000 positions find their
    matches only through the rescue pass)."""
    bufs = batch()[0]
    if one_row:
        bufs = np.tile(bufs[0, :20000], 7)[None, :2 * N].copy()
    want = jax_candidates(config)(jnp.asarray(bufs),
                                  jnp.asarray(lengths, jnp.int32))
    options = {**CANDIDATES, **OPTION_CANDIDATES}[config]
    got = pipeline.parse_candidates(torch.from_numpy(bufs.copy()),
                                    torch.tensor(lengths), **options)
    names = "bp pos lenA dA lenB dB lenC dC d3".split()
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)[:1] if name == "pos" else np.asarray(w)
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype)), name
    assert int((got[2] >= 4).sum()) > 100
    if options.get("hash3"):
        assert bool((got[8] > 0).any())
    return got


# scripts/tier_matrix.py's keyword sets of the options' tests
LEAN_D = dict(depth=6, two_pass=False, hash3=False, passes=2,
              use_content=False, use_wide=False, ladder=to.LEN_LADDER_DENSE)
P1 = dict(depth=6, two_pass=False, hash3=False, passes=1, use_content=False,
          use_wide=False, ladder=to.LEN_LADDER_DENSE2, ext_c=False)
LEAN = dict(P1, strides2=(), refine=0, lit_sample=32)


def check_pallas_with(options, args):
    """``compress_chunks_optimal_pallas_with(**options)`` on the batch
    ``args`` against ``_compress_chunks_optimal_pallas(**options)`` in
    interpret mode run on each chunk alone (B = 1: with a further cost
    pass the Pallas twin reads one chunk's match costs for a 1024-lane
    block, the port each chunk's own, as the XLA entries do); words and
    total_bits equal, every fragment inflates to its chunk.  Returns the
    port's (words, total_bits)."""
    bufs, lengths, bfinal = args
    fn = jax.jit(functools.partial(to._compress_chunks_optimal_pallas,
                                   interpret=True, **options))
    words, total_bits = lt.compress_chunks_optimal_pallas_with(
        *args, device="cpu", **options)
    for k in range(bufs.shape[0]):
        w_j, t_j = fn(*(jnp.asarray(x[k:k + 1]) for x in args))
        assert int(total_bits[k]) == int(t_j[0])
        assert np.array_equal(words[k].numpy().view(np.uint32),
                              np.asarray(w_j[0]))
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()
    return words, total_bits
