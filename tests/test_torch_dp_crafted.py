"""The port's plain DP on crafted inputs against interpret-mode Pallas.

``libdeflate_tpu_torch.compress.kernels.dp_parse_plain`` against
``libdeflate_tpu.compress.pallas_kernels.dp_parse_pallas`` (interpret
mode, ladder ``LEN_LADDER_DENSE2``) on every set of
``libdeflate_tpu_torch/experiments/crafted_dp.py``: ties everywhere, B
and C longer than A, d3 against the cheapest offset cost, every cap
exceeded, distances and d3 past their packed bits, lengths past 258 and
past the packed length's sign bit, negative fields, and all-literal
chunks.  One shape for every set (B = 2, n_pad = 512, S = 256), so that
Pallas compiles once.

The Pallas kernel reads one lc row for a whole 1024-lane block (its
first chunk's); the port reads each lane's own chunk's row, which is
``_dp_parse``'s semantics (``ROADMAP.md`` queue 3).  Where a set has a
row per chunk, chunk b's reference is Pallas run with row b for both
chunks.  Tolerance: exact.

Also: the sources of ``experiments/dp_variants.py`` (each variant of
``csrc/dp_parse.cu`` it measures is one substitution), and
``crafted_dp.random_inputs`` against the JAX test's generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress.pallas_kernels import dp_parse_pallas
from libdeflate_tpu_torch import _build
from libdeflate_tpu_torch.compress import kernels, optimal
from libdeflate_tpu_torch.experiments import crafted_dp, dp_variants

SETS = crafted_dp.dp_sets()


def _pallas(arrays, lc):
    """(span, dist) of interpret-mode Pallas, each chunk under its own lc
    row."""
    a = [jnp.asarray(x.astype(np.int32)) for x in arrays]

    def run(row):
        lc_b = np.stack([row] * crafted_dp.DP_B).astype(np.int32)
        s, d = dp_parse_pallas(*a, jnp.asarray(lc_b), S=crafted_dp.DP_S,
                               interpret=True, ladder=to.LEN_LADDER_DENSE2)
        return np.asarray(s), np.asarray(d)

    if lc.ndim == 1:
        return run(lc)
    both = [run(lc[b]) for b in range(crafted_dp.DP_B)]
    return tuple(np.stack([both[b][k][b] for b in range(crafted_dp.DP_B)])
                 for k in range(2))


@pytest.mark.parametrize("name", list(SETS))
def test_plain_dp_matches_pallas_on_crafted_set(name):
    arrays, lc = SETS[name]
    want_s, want_d = _pallas(arrays, lc)
    span, dist = kernels.dp_parse_plain(
        *[torch.from_numpy(x) for x in arrays], torch.from_numpy(lc),
        crafted_dp.DP_S)
    assert np.array_equal(span.numpy(), want_s)
    assert np.array_equal(dist.numpy(), want_d)


def test_crafted_sets_reach_their_edges():
    """Each set holds what its name says, so that no edge goes untested
    by accident."""
    def field(name, i):
        return SETS[name][0][i]
    ties = SETS["every edge ties"]
    assert (ties[0][0] == 20).all() and (ties[1][3:] == 20 * np.arange(
        2, crafted_dp.LC_ENTRIES - 1)).all()
    name = "B or C longer than A, equal offset costs"
    assert (field(name, 4) > field(name, 1)).any()
    assert (field(name, 7) > field(name, 1)).any()
    name = "every cap exceeded, per-chunk lc"
    assert field(name, 0).max() > 255 and field(name, 3).max() > 1023
    assert SETS[name][1].max() > 1 << 20 and SETS[name][1].ndim == 2
    name = "distances past 16 and 18 bits, d3 past 14 and 22 bits"
    assert field(name, 2).max() >= 1 << 18 and field(name, 10).max() >= 1 << 22
    assert ((field(name, 10) >= 1 << 14) & (field(name, 10) < 1 << 15)).any()
    name = "lengths 0-2, 259-8191 and 8192 or more"
    assert field(name, 1).max() >= 8192 and (field(name, 1) < 3).any()
    assert (field(name, 0) < 0).sum() == 0
    assert (field("negative fields", 0) < 0).any()
    name = "all literal at cost 255, no match feasible"
    assert (field(name, 0) >= 255).all() and (field(name, 1) < 3).all()
    span, _ = kernels.dp_parse_plain(
        *[torch.from_numpy(x) for x in SETS[name][0]],
        torch.from_numpy(SETS[name][1]), crafted_dp.DP_S)
    assert (span == 1).all()


@pytest.mark.parametrize("name", list(dp_variants.VARIANTS)
                         + list(dp_variants.DIAGNOSTICS))
def test_dp_variant_sources(name):
    """Each measured variant of csrc/dp_parse.cu is the source with its
    one substitution: the as-built variant is the source itself."""
    src = (_build.SRC_DIR / "dp_parse.cu").read_text()
    out = dp_variants.variant_source(src, name)
    assert (out == src) == (name == "G8 W4 (as built)")
    assert len(out.splitlines()) == len(src.splitlines())


def test_random_inputs_match_the_jax_test_generator():
    """crafted_dp.random_inputs draws what the JAX package's DP kernel
    test draws, at its shape."""
    args = crafted_dp.random_inputs("cpu", B=2, n_pad=512)
    rng = np.random.default_rng(0)
    cost_lit = rng.integers(16, 180, (2, 512))
    lenA = rng.integers(0, 259, (2, 512))
    assert np.array_equal(args[0].numpy(), cost_lit)
    assert np.array_equal(args[1].numpy(), lenA)
    assert np.array_equal(args[12].numpy(), optimal.SEED_LC_LEN)
