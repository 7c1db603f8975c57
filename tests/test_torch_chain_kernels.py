"""C3 and C4, the candidates' chain extension, on the CPU.

csrc/chain_extend.cu (C3 ``chain_kernels.chain_extend_multi``, the
multi-stride relaxation; C4 ``chain_kernels.chain_extend`` and
``chain_extend2``, the stride-8 doubling) runs only on the card.  This
file holds:

- (a) the numpy mirrors of the kernels' walk
  (libdeflate_tpu_torch/experiments/crafted_chain.py: a persistent grid
  of runs of tiles walked down each row, each step's first s positions
  carried to the tile below, a prologue above a run's first tile, zero
  fill past the row's end, every new value computed from the old ones
  and then written) against the plain versions at tiles of 64 and 256
  positions on the crafted sets (rows of 5000 positions, a multiple of
  no tile; chains across tiles; ties between j; dist 0; lengths past 258
  before the clamp; negative lengths; the row's last positions), at
  every stride set the repository passes, with the sets' reach of each
  trap asserted; on rows of other shapes (rows shorter than a tile;
  short rows of several tiles, where runs cross rows and the tile loaded
  next ends a row) over a grid of fewer blocks than tiles; and over
  grids of 1, 7 and 1000 blocks;
- (b) the wrappers on CPU tensors against the JAX package's
  libdeflate_tpu/compress/tpu_pipeline.py::_chain_extend_multi for the
  cases tests/test_torch_content.py::test_chain_extend_multi leaves out
  (K = 2 over one round, strides1 (1, 2, 8, 32, 128) and (1, 4, 16,
  128), strides2 (32, 64, 128)), and against _chain_extend and
  _chain_extend2, on the crafted sets;
- (c) the routing: a CPU run of lean, dyn1 and dyn2 calls the three
  wrappers (a spy on the module);
- (d) the checks that reject a K outside {2, 3, 5} and strides the kernel
  does not take, before any launch;
- (e) experiments/chain_variants.py's arguments and the main-path inputs
  it records from one call of each tier.

The kernels themselves are held to the plain versions on the card by
chip_smoke.py on the same sets and tiles.  Tolerance: exact.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.compress import chain_kernels as ck
from libdeflate_tpu_torch.compress import bits, dynamic, optimal
from libdeflate_tpu_torch.experiments import crafted_chain as cc

from test_torch_pipeline import text_chunk

# the stride sets a K runs at in the repository: lean's K = 2 one round,
# K = 3 and 5 two
MAIN_STRIDES = {2: cc.STRIDE_SETS["one default round (lean)"],
                3: cc.STRIDE_SETS["two default rounds"],
                5: cc.STRIDE_SETS["two default rounds"]}


def batch(sets):
    """Every crafted set stacked into one [2 * sets, N] batch: a list of
    triples of numpy arrays."""
    per = list(sets.values())
    return [tuple(np.concatenate([s[k][i] for s in per]) for i in range(3))
            for k in range(len(per[0]))]


def torch_cands(cands):
    return [tuple(torch.from_numpy(x) for x in c) for c in cands]


def jax_args(cands):
    return [jnp.asarray(x, jnp.int32) for c in cands for x in c]


def assert_pairs(got, want, what):
    for i, ((gl, gd), (wl, wd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl),
                                      err_msg=f"{what}: len {i}")
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd),
                                      err_msg=f"{what}: dist {i}")


# ---- (a) the mirrors of the kernels' schedule --------------------------

@pytest.mark.parametrize("tile", cc.MIRROR_TILES)
@pytest.mark.parametrize("K", cc.RELAX_KS)
def test_relax_mirror(K, tile):
    cands = batch(cc.relax_sets(K))
    s1, s2 = MAIN_STRIDES[K]
    want = ck.chain_extend_multi_plain(torch_cands(cands), s2, s1)
    assert_pairs(cc.relax_mirror(cands, s1, s2, tile), want,
                 f"K={K}, tile {tile}")


@pytest.mark.parametrize("name", list(cc.STRIDE_SETS))
def test_relax_mirror_strides(name):
    s1, s2 = cc.STRIDE_SETS[name]
    cands = batch(cc.relax_sets(2))
    want = ck.chain_extend_multi_plain(torch_cands(cands), s2, s1)
    assert_pairs(cc.relax_mirror(cands, s1, s2, 64), want, name)


def test_relax_sets_reach_the_traps():
    """At tile 64, K = 3, two rounds: every set splices from the halo and
    reads past the row's end; the named sets reach their traps."""
    reach = {}
    for name, cands in cc.relax_sets(3).items():
        st = Counter()
        cc.relax_mirror(cands, tile=64, stats=st)
        assert st["halo"] > 0 and st["zero_fill"] > 0, name
        reach[name] = st
    assert reach["chains across tiles"]["over_258"] > 0
    assert reach["lengths past 258"]["over_258"] > 0
    assert reach["ties between j"]["tie"] > 1000
    assert reach["negative lengths and remainders"]["zero_take"] > 0
    # dist 0 matches like any other distance: its splices are taken
    plain = ck.chain_extend_multi_plain(
        torch_cands(cc.relax_sets(3)["dist 0"]))
    raw = cc.relax_sets(3)["dist 0"][0][0]
    assert bool((plain[0][0].numpy()[:, 1200:1800]
                 > np.minimum(raw[:, 1200:1800] + 3, 258)).any())


@pytest.mark.parametrize("tile", cc.MIRROR_TILES)
@pytest.mark.parametrize("nc", [1, 2])
def test_double_mirror(nc, tile):
    cands = batch(cc.double_sets(nc))
    tc = torch_cands(cands)
    want = (ck.chain_extend_plain(*tc[0]) if nc == 1
            else ck.chain_extend2_plain(*tc[0], *tc[1]))
    assert_pairs([cc.double_mirror(cands, tile)], [want],
                 f"{nc} candidates, tile {tile}")


def test_double_sets_reach_the_traps():
    reach = {}
    for nc in (1, 2):
        for name, cands in cc.double_sets(nc).items():
            st = Counter()
            cc.double_mirror(cands, 64, stats=st)
            reach[nc, name] = st
    for nc in (1, 2):
        assert reach[nc, "doubling across tiles"]["halo"] > 0
        assert reach[nc, "doubling across tiles"]["over_258"] > 0
        assert reach[nc, "the row's last positions"]["zero_take"] > 0
        assert reach[nc, "dist 0"]["zero_take"] > 0
    splices = reach[2, "splices through the other candidate"]
    assert min(splices[k] for k in ("tA1", "tA2", "tB1", "tB2")) > 1000
    assert reach[2, "ties between A and B"]["tie_ab"] > 1000


@pytest.mark.parametrize("K", cc.RELAX_KS)
def test_relax_mirror_shapes(K):
    """The walk's own traps (``crafted_chain.SHAPES``) at tiles 64 and 256
    over a grid of SHAPE_BLOCKS blocks: rows shorter than a tile, runs
    that cross rows, prologues, the tile loaded next ending a row."""
    s1, s2 = MAIN_STRIDES[K]
    reach = Counter()
    for name, cands in cc.relax_shape_sets(K).items():
        want = ck.chain_extend_multi_plain(torch_cands(cands), s2, s1)
        for tile in cc.MIRROR_TILES:
            st = Counter()
            assert_pairs(cc.relax_mirror(cands, s1, s2, tile,
                                         cc.SHAPE_BLOCKS, st), want,
                         f"K={K}, {name}, tile {tile}")
            reach[name, "short_row"] += st["short_row"]
            for trap in ("walk", "row_cross", "prologue", "end_in_prefetch",
                         "halo", "zero_take"):
                reach[trap] += st[trap]
    assert reach["rows shorter than a tile", "short_row"] > 0
    assert min(reach[t] for t in ("walk", "row_cross", "prologue",
                                  "end_in_prefetch", "halo",
                                  "zero_take")) > 0, dict(reach)


@pytest.mark.parametrize("nc", [1, 2])
def test_double_mirror_shapes(nc):
    reach = Counter()
    for name, cands in cc.double_shape_sets(nc).items():
        tc = torch_cands(cands)
        want = (ck.chain_extend_plain(*tc[0]) if nc == 1
                else ck.chain_extend2_plain(*tc[0], *tc[1]))
        for tile in cc.MIRROR_TILES:
            st = Counter()
            assert_pairs([cc.double_mirror(cands, tile, cc.SHAPE_BLOCKS,
                                           st)], [want],
                         f"{nc} candidates, {name}, tile {tile}")
            reach.update(st)
    assert min(reach[t] for t in ("short_row", "walk", "row_cross",
                                  "prologue", "end_in_prefetch",
                                  "halo")) > 0, dict(reach)


@pytest.mark.parametrize("blocks", [1, 7, 1000])
def test_mirrors_over_grids(blocks):
    """Any grid gives the plain versions' answer: one block walking every
    tile of both rows, a few, and more blocks than tiles."""
    cands = cc.relax_sets(2)["chains across tiles"]
    want = ck.chain_extend_multi_plain(torch_cands(cands), (), cc.STRIDES)
    assert_pairs(cc.relax_mirror(cands, cc.STRIDES, (), 64, blocks), want,
                 f"{blocks} blocks")
    two = cc.double_sets(2)["splices through the other candidate"]
    tc = torch_cands(two)
    assert_pairs([cc.double_mirror(two, 64, blocks)],
                 [ck.chain_extend2_plain(*tc[0], *tc[1])], f"{blocks} blocks")


# ---- (b) the wrappers on CPU tensors against JAX ------------------------

@pytest.mark.parametrize("K,name", [
    (2, "one default round (lean)"), (2, "s4 (1, 4, 16, 128) alone"),
    (3, "s5 (1, 2, 8, 32, 128) then (32, 64, 128)"),
    (3, "s4 (1, 4, 16, 128) then the defaults"),
    (5, "the defaults then (32, 64, 128)"),
    (5, "s5 (1, 2, 8, 32, 128) then (32, 64, 128)")])
def test_relax_wrapper_against_jax(K, name):
    s1, s2 = cc.STRIDE_SETS[name]
    cands = batch(cc.relax_sets(K))
    got = ck.chain_extend_multi(torch_cands(cands), s2, s1)
    want = jax.vmap(lambda *x: tp._chain_extend_multi(
        [x[3 * k:3 * k + 3] for k in range(K)], strides2=s2,
        strides1=s1))(*jax_args(cands))
    assert_pairs(got, want, f"K={K}, {name}")


def test_double_wrappers_against_jax():
    one = batch(cc.double_sets(1))
    want = jax.vmap(tp._chain_extend)(*jax_args(one))
    assert_pairs([ck.chain_extend(*torch_cands(one)[0])], [want],
                 "chain_extend")
    two = batch(cc.double_sets(2))
    want = jax.vmap(tp._chain_extend2)(*jax_args(two))
    got = ck.chain_extend2(*(x for c in torch_cands(two) for x in c))
    assert_pairs([got], [want], "chain_extend2")
    assert int(got[0].max()) == bits.MAX_LEN


# ---- (c) the routing ----------------------------------------------------

@pytest.mark.parametrize("tier,entry,wanted", [
    ("lean", optimal.compress_chunks_lean, {"chain_extend_multi"}),
    ("dyn1", dynamic.compress_chunks_dynamic, {"chain_extend"}),
    # the A/B extension, and the rescue pass's one-candidate one
    ("dyn2", dynamic.compress_chunks_dynamic2,
     {"chain_extend2", "chain_extend"}),
])
def test_entries_reach_the_wrappers(monkeypatch, tier, entry, wanted):
    calls = Counter()
    for name in ("chain_extend_multi", "chain_extend", "chain_extend2"):
        def spy(*args, _name=name, _orig=getattr(ck, name), **kw):
            calls[_name] += 1
            return _orig(*args, **kw)
        monkeypatch.setattr(ck, name, spy)
    bufs = np.stack([text_chunk(4096), text_chunk(4096)[::-1].copy()])
    entry(bufs, np.array([4096, 3000]), np.array([True, True]),
          device="cpu")
    assert set(calls) == wanted and all(calls[n] == 1 for n in wanted), \
        (tier, dict(calls))


# ---- (e) the measurement script's arguments and inputs ---------------

def test_chain_variants_arguments():
    from pathlib import Path

    from libdeflate_tpu_torch.experiments import chain_variants as cv
    assert cv.parse_args([]) is None
    assert cv.parse_args(["--against", "old"]) == Path("old")
    for bad in (["--variants", "no warp skip"], ["--tiles"], ["--against"],
                ["--against", "old", "new"]):
        with pytest.raises(SystemExit):
            cv.parse_args(bad)


def test_chain_variants_records_the_main_inputs():
    """One CPU call of each tier gives the inputs the script times:
    lean's K = 2 over one round, optimal's K = 5 over two, dyn1's one
    candidate and dyn2's two, and profile_lean's K = 3 over two."""
    from libdeflate_tpu_torch.experiments import chain_variants as cv
    bufs = torch.from_numpy(np.stack([text_chunk(4096),
                                      text_chunk(4096)[::-1].copy()]))
    got = cv.record_inputs(bufs, torch.tensor([4096, 3000]),
                           torch.tensor([True, True]), device="cpu")
    assert {t: name for t, (name, _) in got.items()} == {
        "lean": "chain_extend_multi", "optimal": "chain_extend_multi",
        "dyn1": "chain_extend", "dyn2": "chain_extend2",
        "profile_lean x3": "chain_extend_multi"}
    shapes = {}
    for tier, (name, args) in got.items():
        cands, strides = cv.split(name, args)
        assert all(x.shape == (2, 4096) and x.dtype == torch.int64
                   for c in cands for x in c), tier
        shapes[tier] = (len(cands), strides)
    assert shapes == {"lean": (2, cc.STRIDES), "optimal": (5, cc.STRIDES * 2),
                      "dyn1": (1, None), "dyn2": (2, None),
                      "profile_lean x3": (3, cc.STRIDES * 2)}


# ---- (d) what the kernels take ------------------------------------------

@pytest.mark.parametrize("K", [0, 1, 4, 6])
def test_relax_rejects_other_k(K):
    with pytest.raises(ValueError, match="candidates"):
        ck.check_relax(K, cc.STRIDES)


@pytest.mark.parametrize("strides", [(0,), (1, -2), (1,) * 17,
                                     (512, 512, 1)])
def test_relax_rejects_other_strides(strides):
    with pytest.raises(ValueError, match="strides"):
        ck.check_relax(3, strides)


@pytest.mark.parametrize("K, strides, tile, fits", [
    (5, (684,), ck.TILE, True), (5, (685,), ck.TILE, False),
    (5, (600, 424), ck.TILE, False), (5, (1024,), 512, True),
    (3, (1024,), ck.TILE, True), (5, cc.STRIDES * 2, ck.TILE, True)])
def test_relax_takes_what_shared_memory_holds(K, strides, tile, fits):
    """A block's shared memory (two tile buffers and the carry, 227 KiB
    less the strides' copy) bounds the strides at K = 5: one stride of
    at most 684 at the default tile, more at a smaller tile."""
    assert (ck.smem_bytes(K, strides, tile) <= ck.MAX_SMEM) == fits
    if fits:
        ck.check_relax(K, strides, tile)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ck.check_relax(K, strides, tile)


def test_relax_checks_before_launch():
    """Off the CPU a K outside {2, 3, 5} raises in the wrapper before any
    build or launch (tensors on the meta device, which has no kernel);
    the CPU takes the plain version at any K."""
    meta = [tuple(torch.zeros(2, 64, dtype=torch.int64, device="meta")
                  for _ in range(3)) for _ in range(4)]
    with pytest.raises(ValueError, match="candidates"):
        ck.chain_extend_multi(meta)
    with pytest.raises(ValueError, match="contiguous int64"):
        ck.chain_extend(*(torch.zeros(2, 64, dtype=torch.int32,
                                      device="meta"),) * 3)
    cpu = [tuple(torch.zeros(2, 64, dtype=torch.int64) for _ in range(3))
           for _ in range(4)]
    assert len(ck.chain_extend_multi(cpu)) == 4


class _StandIn:
    """A launch function that keeps its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_bare_launches_pass_the_kernel_its_arguments(monkeypatch):
    """The bare launches through a stand-in library (no card): the
    pointers of every input and output in order, K, rows, n, the strides
    (strides1 then strides2) and the tile, and the signature set once."""
    import contextlib
    import ctypes

    from libdeflate_tpu_torch import _build
    fns = {"chain_relax_launch": _StandIn(),
           "chain_double_launch": _StandIn()}
    lib = type("Lib", (), fns)()
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "launch_context", lambda tensors, what:
                        contextlib.nullcontext(ctypes.c_void_p(0)))
    cands = [tuple(torch.zeros(3, 100, dtype=torch.int64) for _ in range(3))
             for _ in range(5)]
    outs = [torch.empty(3, 100, dtype=torch.int64) for _ in range(5)]
    for _ in range(2):
        ck.chain_relax_into(cands, (1, 4, 16, 128, 32, 64, 128), outs, 64)
    ins, outp, K, rows, n, st, nst, tile, _ = \
        fns["chain_relax_launch"].calls[0]
    assert [ins[i] for i in range(15)] == [x.data_ptr() for c in cands
                                           for x in c]
    assert [outp[i] for i in range(5)] == [o.data_ptr() for o in outs]
    assert (K, rows, n, nst, tile) == (5, 3, 100, 7, 64)
    assert [st[i] for i in range(nst)] == [1, 4, 16, 128, 32, 64, 128]
    assert len(fns["chain_relax_launch"].calls) == 2
    assert len(fns["chain_relax_launch"].argtypes) == 9
    ck.chain_double_into(cands[:2], outs[:2])
    ins, outp, K, rows, n, tile, _ = fns["chain_double_launch"].calls[0]
    assert [ins[i] for i in range(6)] == [x.data_ptr() for c in cands[:2]
                                          for x in c]
    assert (K, rows, n, tile) == (2, 3, 100, ck.TILE)
