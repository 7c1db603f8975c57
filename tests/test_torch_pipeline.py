"""The port's lean pipeline stages against the JAX package's.

libdeflate_tpu_torch/compress/pipeline.py, with bits.py and the plain
versions in scan_kernels.py and kernels.py, against
libdeflate_tpu/compress/tpu_pipeline.py: _parse_candidates (lean arm:
depth 6, 128 KiB windows, no content pass, no wide payloads, ext_c=False,
strides2=()), _greedy_commit_merge, _exclusive_bit_offsets,
_group_premerge and _group_place.  Inputs: one text chunk (this
repository's SURVEY.md), one 64-byte-record chunk with 5% noise, both
64 KiB (16-bit sort keys), and one 256 KiB chunk (17-bit keys), all made
with numpy from fixed seeds.  Tolerance: exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import (bits, dynamic, kernels, optimal,
                                          pipeline, scan_kernels)

REPO = Path(__file__).resolve().parents[1]
N = 1 << 16
LEAN = dict(depth=6, two_pass=False, hash3=False, wide_window=True,
            use_content=False, use_wide=False, ext_c=False, lcp=16,
            strides2=())


def text_chunk(n):
    raw = (REPO / "SURVEY.md").read_bytes()
    return np.frombuffer((raw * (n // len(raw) + 1))[:n], np.uint8)


def records_chunk(n, seed=11):
    rng = np.random.default_rng(seed)
    rec = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), n // 64)
    noise = rng.integers(0, 256, n, dtype=np.uint8)
    return np.where(rng.random(n) < 0.05, noise, rec).astype(np.uint8)


CHUNKS = {
    "text": lambda: (text_chunk(N), N),
    "records": lambda: (records_chunk(N), N),
    "text_short": lambda: (text_chunk(N), 40000),
    "text_256k": lambda: (np.concatenate([text_chunk(1 << 17),
                                          records_chunk(1 << 17, 5)]),
                          1 << 18),
}

_jax_candidates = jax.jit(functools.partial(tp._parse_candidates, **LEAN))


@functools.lru_cache(maxsize=None)
def port_parse(kind):
    """The port's lean candidates, costs, DP and commit for one chunk."""
    b, length = CHUNKS[kind]()
    bt = torch.from_numpy(b.copy())[None]
    lt = torch.tensor([length])
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(bt, lt)
    cost = optimal.literal_costs(bp, lt, optimal.literal_cost_table(bp, lt))
    span, dist = kernels.dp_parse(
        cost, lenA, dA, optimal.dist_cost(dA), lenB, dB,
        optimal.dist_cost(dB), lenC, dC, optimal.dist_cost(dC), d3,
        optimal.dist_cost(d3), torch.from_numpy(optimal.SEED_LC_LEN),
        optimal.DP_SEG)
    return bp, pos, span, dist, lt


def test_segment_sizes_and_key_params():
    for n in (1, 127, 128, 511, 512, 40000, 1 << 16, (1 << 17) - 1,
              1 << 17, 1 << 18, 1 << 20, (1 << 20) + 5):
        sizes = bits.segment_sizes(n)
        assert sizes == tp._segment_sizes(n, wide=True), n
        assert bits.seg_key_params(sizes[1]) == \
            tp._seg_key_params(sizes[1]), n


@pytest.mark.parametrize("kind", list(CHUNKS))
def test_parse_candidates_lean(kind):
    b, length = CHUNKS[kind]()
    want = [np.asarray(x) for x in
            _jax_candidates(jnp.asarray(b), jnp.int32(length))]
    got = pipeline.parse_candidates_lean(torch.from_numpy(b.copy())[None],
                                         torch.tensor([length]))
    names = "bp pos lenA dA lenB dB lenC dC d3".split()
    for name, g, w in zip(names, got, want):
        assert np.array_equal(g[0].numpy(), w.astype(g.numpy().dtype)), name


@pytest.mark.parametrize("kind", ["text", "records", "text_short"])
@pytest.mark.parametrize("seg", [512, 1024])
def test_greedy_commit_merge(kind, seg):
    _, _, span, dist, _ = port_parse(kind)
    is_match = (span >= 3) & (dist > 0)
    want = tp._greedy_commit_merge(jnp.asarray(span[0].numpy(), jnp.int32),
                                   jnp.asarray(is_match[0].numpy()),
                                   jnp.asarray(dist[0].numpy(), jnp.int32),
                                   seg)
    got = scan_kernels.greedy_commit_merge(span, is_match, dist, seg)
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))


def test_greedy_commit_merge_random_spans():
    rng = np.random.default_rng(4)
    n = 4096
    span = rng.integers(1, 300, n)
    dist = rng.choice([1, 2, 7, 300], n)
    is_match = rng.random(n) < 0.7
    want = tp._greedy_commit_merge(jnp.asarray(span, jnp.int32),
                                   jnp.asarray(is_match),
                                   jnp.asarray(dist, jnp.int32), 512)
    got = scan_kernels.greedy_commit_merge(
        torch.from_numpy(span)[None], torch.from_numpy(is_match)[None],
        torch.from_numpy(dist)[None], 512)
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1 << 16, 1 << 20, 1000, 128])
def test_exclusive_bit_offsets(n):
    rng = np.random.default_rng(n)
    nb = rng.integers(0, 25, n).astype(np.int32)
    want_offs, want_total = tp._exclusive_bit_offsets(jnp.asarray(nb))
    offs, total = pipeline.exclusive_bit_offsets(torch.from_numpy(nb)[None])
    assert np.array_equal(offs[0].numpy(), np.asarray(want_offs))
    assert int(total[0]) == int(want_total)


def _pack_generator():
    """The generator of test_pack_kernel_matches_scatter."""
    rng = np.random.default_rng(1)
    n = 128 * 40
    nbits = rng.integers(1, 10, n).astype(np.int32)
    values = rng.integers(0, 1 << 31, n).astype(np.uint32) & (
        (np.uint32(1) << nbits.astype(np.uint32)) - 1)
    offs = np.concatenate([[0], np.cumsum(nbits)[:-1]]).astype(np.int32)
    nwords = int((offs[-1] + nbits[-1] + 31) // 32) + 2
    return values, nbits, offs, nwords


def _emit_items(kind):
    bp, pos, span, dist, lt = port_parse(kind)
    cm, cl, eff = optimal.commit(span, dist, pos, lt, optimal.DP_SEG)
    (val, nb, offs), _ = dynamic.emit_dynamic_pre(bp, cm, cl, eff, dist)
    nwords = dynamic.dyn_nwords(N)
    return val[0].numpy(), nb[0].numpy(), offs[0].numpy(), nwords


@pytest.mark.parametrize("source", ["generator", "text", "records"])
@pytest.mark.parametrize("capw", [37, dynamic.DYN_CAPW])
def test_group_premerge_and_place(source, capw):
    if source == "generator":
        values, nbits, offs, nwords = _pack_generator()
    else:
        values, nbits, offs, nwords = _emit_items(source)
    sbuf_j, gw_j = tp._group_premerge(
        jnp.asarray(values.astype(np.uint32)), jnp.asarray(nbits, jnp.int32),
        jnp.asarray(offs, jnp.int32), capw=capw)
    sbuf, gw = pipeline.group_premerge(
        torch.from_numpy(values.astype(np.int64))[None],
        torch.from_numpy(nbits.astype(np.int64))[None],
        torch.from_numpy(offs.astype(np.int64))[None], capw=capw)
    assert np.array_equal(sbuf[0].numpy(), np.asarray(sbuf_j).astype(np.int64))
    assert np.array_equal(gw[0].numpy(), np.asarray(gw_j))
    want = np.asarray(tp._group_place(sbuf_j, gw_j, nwords))
    got = kernels.group_place(sbuf, gw, nwords)[0].numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_device_stream_to_bytes():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    for bits_ in (0, 1, 8, 9, 1599):
        want = tp.device_stream_to_bytes(words, bits_)
        assert pipeline.device_stream_to_bytes(words, bits_) == want
        as_i32 = torch.from_numpy(words.view(np.int32))
        assert pipeline.device_stream_to_bytes(as_i32, bits_) == want
