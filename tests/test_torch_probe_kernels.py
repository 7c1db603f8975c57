"""C5, the sorted matchfind's probes after the sort, on the CPU.

csrc/segment_probe.cu (``probe_kernels.segment_probe``) runs only on the
card.  This file holds:

- (a) the numpy mirror of the kernel's walk
  (libdeflate_tpu_torch/experiments/crafted_probe.py: tiles of sorted
  slots with the ``depth`` before them in "shared" arrays, payloads read
  once from the bytes by aligned words funnel-shifted to the byte, the
  probes' gate and word LCP, the best and a second pass for the
  runner-up, every output at its slot's position) against the plain
  versions (``probe_kernels.sorted_best``, ``sorted_matchfind_lean``)
  at tiles of 64 and 256 slots, on the crafted sets at every (form,
  depth, payload width) the callers run, with each set's reach asserted:
  equal hashes across tile edges and at a segment's first slots, the junk
  hash over equal bytes (32767 a real hash at 128 KiB segments), dist
  32768 and 32769, LCPs 0-16, payloads past the row's end, ties, no
  second distance, short rows;
- (b) the wrapper on CPU tensors against the plain versions on payload
  words made as the parsers made them and against the JAX package's
  libdeflate_tpu/compress/tpu_pipeline.py::_sorted_matchfind (chain
  extended for the best form, ``return_triple`` for the lean one), at 64
  and 128 KiB segments and the rescue pass's half-segment offset;
- (c) the routing: a CPU run of static, dyn1, lean, optfast, the mesh's
  level 5-7 options, dyn2 and deep (their rescue passes) calls the
  wrapper (a spy), and the 32-byte triple of optimal does not;
- (d) the checks that reject a form, payload width or depth the kernel
  does not take, before any launch, and the bare launch's arguments.

The kernel itself is held to the plain versions on the card by
chip_smoke.py on the same sets and on the main path's shapes.
Tolerance: exact.
"""

import contextlib
import ctypes
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch import _build
from libdeflate_tpu_torch.compress import chain_kernels as ck
from libdeflate_tpu_torch.compress import bits, dynamic, optimal, pipeline
from libdeflate_tpu_torch.compress import probe_kernels as pk
from libdeflate_tpu_torch.experiments import crafted_probe as cp

from test_torch_pipeline import text_chunk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (the suite's workers would
    oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def sets():
    return cp.probe_sets()


def flat(form, out):
    return list(out) if form == "best" else [x for t in out for x in t]


@functools.lru_cache(maxsize=None)
def plain(name, form, depth, width):
    h, bp, seg, shift = sets()[name]
    out = pk.segment_probe(torch.from_numpy(h), torch.from_numpy(bp), seg,
                           depth, width, form, shift)
    return [x.numpy() for x in flat(form, out)]


def assert_all(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: output {i}")


# ---- (a) the mirror of the kernel's walk ------------------------------

def test_set_names():
    assert tuple(sets()) == cp.SET_NAMES


# what each set must reach, from the mirror's counters over every run
REACH = {
    "text, 128 KiB": ("halo", "tie", "junk_real", "lcp_1"),
    "text, 64 KiB": ("halo", "tie", "zero_fill"),
    "one byte, one hash": ("wrap", "halo", "lcp_16", "zero_fill"),
    "planted, 128 KiB": ("window", "window_plus", "junk_real", "tie",
                         "zero_fill", "b_zero", "b_zero_match",
                         *(f"lcp_{k}" for k in range(17))),
    "planted, 64 KiB": ("window", "window_plus", "junk_real", "tie",
                        "zero_fill", *(f"lcp_{k}" for k in range(17))),
    "planted, 128 KiB, half a segment on": ("zero_fill", "lcp_16"),
    "planted, 64 KiB, half a segment on": ("zero_fill", "lcp_16"),
    "short, n_pad 384": ("short", "halo", "zero_fill"),
    "short, n_pad 5120": ("short", "halo"),
}


@pytest.mark.parametrize("tile", cp.MIRROR_TILES)
@pytest.mark.parametrize("name", cp.SET_NAMES)
def test_mirror(name, tile):
    """Every run of the set through the mirror at ``tile`` equals the
    plain version; at tile 64 the set reaches what it was made for."""
    h, bp, seg, shift = sets()[name]
    st = Counter() if tile == 64 else None
    for form, depth, width in cp.RUNS:
        got = cp.mirror(h, bp, seg, depth, width, form, shift, tile, st)
        assert_all(flat(form, got), plain(name, form, depth, width),
                   f"{name}, {form} depth {depth} width {width}, tile {tile}")
    if st is not None:
        missing = [k for k in REACH[name] if st[k] <= 0]
        assert not missing, (name, missing, dict(st))


def test_window_edge_and_ties_in_the_outputs():
    """The planted pairs as the outputs show them: dist 32768 taken and
    32769 not, the LCP ladder's lengths and remainders, the nearest of
    two equal copies."""
    h, bp, seg, shift = sets()["planted, 64 KiB"]
    mlen, dist, fine = plain("planted, 64 KiB", "best", 6, 16)
    at = 5000 + cp.WINDOW
    assert (mlen[0, at], dist[0, at]) == (16, cp.WINDOW)
    assert dist[1, 7000 + cp.WINDOW + 1] == 0
    for k in range(17):
        p = 50000 + 300 * k + 100 + 7 * k
        want = (0, 0) if k < 4 else ((16, 0) if k == 16 else
                                      (4 * (k // 4), k % 4))
        assert (mlen[0, p], fine[0, p]) == want, k
    assert (mlen[1, 60200], dist[1, 60200]) == (16, 100)
    assert (mlen[1, 61300], fine[1, 61300], dist[1, 61300]) == (8, 2, 200)
    # the junk bucket's copies find nothing
    assert not mlen[0, 1000:1800:20].any()


# ---- (b) the wrapper against the plain versions and JAX ---------------

def parser_words(bp, width, shift):
    """Payload words as the parsers made them before the kernel: the
    le32 words and ``ahead`` copies, shifted half a segment for the
    rescue pass as its ``shift`` did."""
    words = bits.le32_words(bp)
    ws = (words,) + tuple(bits.ahead(words, k)
                          for k in range(4, width, 4))
    if shift:
        ws = tuple(torch.cat([x[:, shift:], torch.zeros_like(x[:, :shift])],
                             1) for x in ws)
    return ws


def as_jax(x):
    return jnp.asarray(x.numpy().astype(np.uint32))


@pytest.mark.parametrize("name, form, depth, width", [
    ("text, 64 KiB", "best", 2, 16), ("text, 128 KiB", "best", 6, 16),
    ("planted, 64 KiB, half a segment on", "best", 2, 8),
    ("text, 64 KiB", "lean", 6, 16), ("text, 128 KiB", "lean", 6, 16),
    ("text, 128 KiB", "lean", 6, 8)])
def test_wrapper_against_plain_and_jax(name, form, depth, width):
    h, bp, seg, shift = sets()[name]
    ht, bt = torch.from_numpy(h), torch.from_numpy(bp)
    got = pk.segment_probe(ht, bt, seg, depth, width, form, shift)
    ws = parser_words(bt, width, shift)
    if form == "best":
        ref = pk.sorted_best(ht, ws, seg, depth)
    else:
        ref = pk.sorted_matchfind_lean(ht, ws, seg, depth)
    assert_all(flat(form, got), flat(form, ref), f"{name}: plain")
    wj = [as_jax(x) for x in ws] + [None] * (4 - len(ws))
    fn = jax.jit(jax.vmap(functools.partial(
        tp._sorted_matchfind, seg=seg, depth=depth,
        return_triple=form == "lean"),
        in_axes=(0, 0, 0) + ((0, 0) if width == 16 else (None, None))))
    want = fn(as_jax(ht), *wj)
    if form == "best":
        assert_all(ck.chain_extend(*got), want, f"{name}: JAX")
    else:
        assert_all(flat(form, got), [x for t in want for x in t],
                   f"{name}: JAX")
    found = int((got[0] if form == "best" else got[0][0]).gt(0).sum())
    assert found > (1000 if name.startswith("text") else 0), found


# ---- (c) the routing ---------------------------------------------------

@pytest.mark.parametrize("tier, entry, wanted", [
    ("static", pipeline.compress_chunks_static, [("best", 2, 16, 0)]),
    ("dyn1", dynamic.compress_chunks_dynamic, [("best", 6, 16, 0)]),
    ("lean", optimal.compress_chunks_lean, [("lean", 6, 16, 0)]),
    ("optfast", optimal.compress_chunks_optfast, [("lean", 6, 16, 0)]),
    ("level5", functools.partial(optimal.compress_chunks_optimal_with,
                                 **optimal.MESH_LEVEL_OPTIONS[5]),
     [("lean", 6, 16, 0)]),
    # the A/B main pass stays plain; the rescue pass goes through C5
    ("dyn2", dynamic.compress_chunks_dynamic2, [("best", 2, 8, 2048)]),
    ("deep", optimal.compress_chunks_optimal_deep, [("best", 2, 8, 2048)]),
    # the 32-byte triple stays plain
    ("optimal", optimal.compress_chunks_optimal, []),
])
def test_entries_reach_the_wrapper(monkeypatch, tier, entry, wanted):
    calls, triples = [], []
    orig = pk.segment_probe

    def spy(h, bp, seg, depth, width, form="best", shift=0):
        calls.append((form, depth, width, shift))
        return orig(h, bp, seg, depth, width, form, shift)

    def triple_spy(*args, _orig=pipeline.sorted_matchfind_triple, **kw):
        triples.append(1)
        return _orig(*args, **kw)
    monkeypatch.setattr(pk, "segment_probe", spy)
    monkeypatch.setattr(pipeline, "sorted_matchfind_triple", triple_spy)
    bufs = np.stack([text_chunk(4096), text_chunk(4096)[::-1].copy()])
    entry(bufs, np.array([4096, 3000]), np.array([True, True]),
          device="cpu")
    assert calls == wanted, (tier, calls)
    assert len(triples) == (tier in ("optimal", "deep")), (tier, triples)


# ---- (d) what the kernel takes -----------------------------------------

@pytest.mark.parametrize("form, width, depth, match", [
    ("triple", 16, 6, "form"), ("wide", 16, 6, "form"),
    ("best", 32, 6, "width"), ("lean", 12, 6, "width"),
    ("best", 16, 0, "depth"), ("lean", 16, pk.MAX_DEPTH + 1, "depth")])
def test_check_rejects(form, width, depth, match):
    with pytest.raises(ValueError, match=match):
        pk.check_probe(form, width, depth)


def test_checks_before_launch():
    """Off the CPU a form, width or depth the kernel does not take, or
    arrays it does not take, raise in the wrapper before any build or
    launch (tensors on the meta device, which has no kernel); the CPU
    takes the plain version at the deepest depth."""
    h = torch.zeros(2, 1024, dtype=torch.int64, device="meta")
    bp = torch.zeros(2, 1024, dtype=torch.uint8, device="meta")
    for args, match in (((1024, 6, 16, "triple"), "form"),
                        ((1024, 6, 24), "width"),
                        ((1024, 40, 16), "depth")):
        with pytest.raises(ValueError, match=match):
            pk.segment_probe(h, bp, *args)
    for hh, bb, seg in ((h.int(), bp, 1024), (h, bp.long(), 1024),
                        (h, bp, 1000)):
        with pytest.raises(ValueError, match="contiguous"):
            pk.segment_probe(hh, bb, seg, 2, 16)
    hc = torch.randint(0, 50, (2, 1024), dtype=torch.int64)
    bc = torch.randint(0, 4, (2, 1024), dtype=torch.uint8)
    out = pk.segment_probe(hc, bc, 1024, pk.MAX_DEPTH, 16, "lean")
    assert len(out) == 3 and out[0][0].shape == (2, 1024)


class _StandIn:
    """A launch function that keeps its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_bare_launch_passes_the_kernel_its_arguments(monkeypatch):
    """The bare launch through a stand-in library (no card): the bytes,
    the keys, every output in order, the scratch, the form, width, rows,
    segment, row length, offset, key parameters and depth, and the
    signature set once."""
    fn = _StandIn()
    lib = type("Lib", (), {"segment_probe_launch": fn})()
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "launch_context", lambda tensors, what:
                        contextlib.nullcontext(ctypes.c_void_p(0)))
    bp = torch.zeros(2, 4096, dtype=torch.uint8)
    keys = torch.zeros(4, 2048, dtype=torch.int64)
    outs = [torch.empty(2, 4096, dtype=torch.int64) for _ in range(9)]
    for _ in range(2):
        pk.segment_probe_into(bp, keys, outs, "lean", 8, 2048, 6, 1024)
    (b, k, o, packed, done, lean, width, rows, seg, n, shift, pos_bits,
     junk, depth, _) = fn.calls[0]
    assert (b, k) == (bp.data_ptr(), keys.data_ptr())
    assert [o[i] for i in range(9)] == [x.data_ptr() for x in outs]
    assert packed and done and packed != done
    assert (lean, width, rows, seg, n, shift, pos_bits, junk, depth) == (
        1, 8, 4, 2048, 4096, 1024, 16, 1 << 15, 6)
    assert len(fn.calls) == 2 and len(fn.argtypes) == 15
    pk.segment_probe_into(bp, keys, outs[:3], "best", 16, 2048, 2)
    assert fn.calls[-1][5:7] == (0, 16)
