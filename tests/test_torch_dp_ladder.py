"""The port's plain DP over the sparse ladder against the JAX package's.

``libdeflate_tpu_torch.compress.kernels.dp_parse_plain`` at
``LEN_LADDER`` (the optimal tiers' 28 rungs) against
``libdeflate_tpu/compress/tpu_optimal.py::_dp_parse(ladder=LEN_LADDER)``
on the JAX kernel test's generator (S = 256, B = 2) and on the lean
candidates of a 64 KiB text chunk (S = 1024), and against
``pallas_kernels.dp_parse_pallas(ladder=LEN_LADDER)`` in interpret mode
on every crafted set of ``experiments/crafted_dp.py`` (B = 2, n_pad =
512, S = 256, one Pallas compile; chunk b of a set with a table per
chunk is held to Pallas run with row b, as in
tests/test_torch_dp_crafted.py).  A ladder the JAX package does not
name raises (LEN_LADDER_DENSE is held to the JAX package in
tests/test_torch_options_ladder.py).  Tolerance: exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress.pallas_kernels import dp_parse_pallas
from libdeflate_tpu_torch.compress import kernels, optimal, pipeline
from libdeflate_tpu_torch.experiments import crafted_dp

REPO = Path(__file__).resolve().parents[1]
SETS = crafted_dp.dp_sets()


def generator():
    """The generator of test_dp_kernel_matches_xla (S=256, B=2)."""
    rng = np.random.default_rng(0)
    B, n_pad = 2, 512
    cost_lit = rng.integers(16, 180, (B, n_pad))
    lenA = rng.integers(0, 259, (B, n_pad))
    dA = rng.integers(1, 32769, (B, n_pad))
    lenB = np.minimum(rng.integers(0, 259, (B, n_pad)), lenA)
    dB = rng.integers(1, 32769, (B, n_pad))
    d3 = np.where(rng.random((B, n_pad)) < 0.5,
                  rng.integers(1, 8193, (B, n_pad)), 0)
    lenC = np.minimum(rng.integers(0, 259, (B, n_pad)), lenA)
    dC = rng.integers(1, 32769, (B, n_pad))
    return 256, (cost_lit, lenA, dA, lenB, dB, lenC, dC, d3)


def parsed_chunk():
    """Lean candidates and seeded literal costs of one 64 KiB text
    chunk."""
    raw = (REPO / "SURVEY.md").read_bytes()
    n = 1 << 16
    b = np.frombuffer((raw * (n // len(raw) + 1))[:n], np.uint8).copy()
    bt, lt = torch.from_numpy(b)[None], torch.tensor([n])
    bp, _, lenA, dA, lenB, dB, lenC, dC, d3 = \
        pipeline.parse_candidates_lean(bt, lt)
    cost = optimal.literal_costs(bp, lt, optimal.literal_cost_table(bp, lt))
    return 1024, tuple(x.numpy() for x in
                       (cost, lenA, dA, lenB, dB, lenC, dC, d3))


@pytest.mark.parametrize("source", ["generator", "parsed chunk"])
def test_plain_dp_matches_xla_dp_on_len_ladder(source):
    S, arrays = generator() if source == "generator" else parsed_chunk()
    cost_lit, lenA, dA, lenB, dB, lenC, dC, d3 = arrays
    dp = jax.jit(functools.partial(to._dp_parse, S=S, ladder=to.LEN_LADDER))
    dc = to._dist_cost
    want = []
    for b in range(cost_lit.shape[0]):
        a = [jnp.asarray(x[b], jnp.int32) for x in arrays]
        want.append(dp(a[0], a[1], a[2], dc(a[2]), a[3], a[4], dc(a[4]),
                       a[5], a[6], dc(a[6]), a[7], dc(a[7]),
                       jnp.asarray(to._SEED_LC_LEN)))
    t = [torch.from_numpy(x.astype(np.int64)) for x in arrays]
    dct = optimal.dist_cost
    span, dist = kernels.dp_parse_plain(
        t[0], t[1], t[2], dct(t[2]), t[3], t[4], dct(t[4]), t[5], t[6],
        dct(t[6]), t[7], dct(t[7]), torch.from_numpy(to._SEED_LC_LEN), S,
        kernels.LEN_LADDER)
    assert np.array_equal(span.numpy(), np.stack([np.asarray(w[0])
                                                  for w in want]))
    assert np.array_equal(dist.numpy(), np.stack([np.asarray(w[1])
                                                  for w in want]))
    # where no tail edge reaches the segment end, a span is a rung or 1
    far = torch.arange(span.shape[1]) % S < S - 258
    assert set(span[:, far].unique().tolist()) <= set(kernels.LEN_LADDER) \
        | {1}
    assert (span > 1).any()


def pallas_sparse(arrays, lc):
    """(span, dist) of interpret-mode Pallas at LEN_LADDER, each chunk
    under its own lc row."""
    a = [jnp.asarray(x.astype(np.int32)) for x in arrays]

    def run(row):
        lc_b = np.stack([row] * crafted_dp.DP_B).astype(np.int32)
        s, d = dp_parse_pallas(*a, jnp.asarray(lc_b), S=crafted_dp.DP_S,
                               interpret=True, ladder=to.LEN_LADDER)
        return np.asarray(s), np.asarray(d)

    if lc.ndim == 1:
        return run(lc)
    both = [run(lc[b]) for b in range(crafted_dp.DP_B)]
    return tuple(np.stack([both[b][k][b] for b in range(crafted_dp.DP_B)])
                 for k in range(2))


@pytest.mark.parametrize("name", list(SETS))
def test_plain_dp_matches_pallas_on_len_ladder(name):
    arrays, lc = SETS[name]
    want_s, want_d = pallas_sparse(arrays, lc)
    span, dist = kernels.dp_parse_plain(
        *[torch.from_numpy(x) for x in arrays], torch.from_numpy(lc),
        crafted_dp.DP_S, kernels.LEN_LADDER)
    assert np.array_equal(span.numpy(), want_s)
    assert np.array_equal(dist.numpy(), want_d)


@pytest.mark.parametrize("ladder", [
    to.LEN_LADDER[:-1], to.LEN_LADDER[::-1], tuple(range(3, 31))],
    ids=["ladder1", "ladder2", "ladder3"])
def test_other_ladders_raise(ladder):
    arrays, lc = SETS["every edge ties"]
    args = [torch.from_numpy(x) for x in arrays] + [torch.from_numpy(lc),
                                                    crafted_dp.DP_S]
    with pytest.raises(ValueError, match="ladder"):
        kernels.dp_parse(*args, ladder)
    with pytest.raises(ValueError, match="ladder"):
        kernels.dp_parse_plain(*args, ladder)
    assert kernels.dp_parse(*args, list(to.LEN_LADDER))[0].shape == \
        arrays[0].shape
