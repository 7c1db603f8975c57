"""The port's plain DP over LEN_LADDER_DENSE against the JAX package's.

``libdeflate_tpu_torch.compress.kernels.dp_parse_plain`` at
``LEN_LADDER_DENSE`` (46 rungs, the ladder of ``scripts/tier_matrix.py``'s
lean variants) against ``libdeflate_tpu/compress/tpu_optimal.py::
_dp_parse(ladder=LEN_LADDER_DENSE)`` on the JAX kernel test's generator
(S = 256, B = 2) and on the lean candidates of a 64 KiB text chunk
(S = 1024), and against ``pallas_kernels.dp_parse_pallas(ladder=
LEN_LADDER_DENSE)`` in interpret mode on every crafted set of
``experiments/crafted_dp.py`` (B = 2, n_pad = 512, S = 256, one Pallas
compile).  The crafted sets exceed the fields' packed caps, which only
the Pallas kernel (and so K1) applies, so they are held to Pallas; chunk
b of a set with a table per chunk is held to Pallas run with row b, as
in tests/test_torch_dp_crafted.py.  The wrapper takes the ladder on the
CPU.  Tolerance: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_tier_cases import one_torch_thread  # noqa: F401
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress.pallas_kernels import dp_parse_pallas
from libdeflate_tpu_torch.compress import kernels, optimal
from libdeflate_tpu_torch.experiments import crafted_dp
from test_torch_dp_ladder import generator, parsed_chunk

SETS = crafted_dp.dp_sets()


def test_dense_ladder_is_the_jax_packages():
    assert kernels.LEN_LADDER_DENSE == tuple(int(f) for f in
                                             to.LEN_LADDER_DENSE)
    assert kernels.ladder_rungs(to.LEN_LADDER_DENSE) == 46
    assert set(kernels.LADDERS) == {28, 46, 80}


@pytest.mark.parametrize("source", ["generator", "parsed chunk"])
def test_plain_dp_matches_xla_dp_on_dense_ladder(source):
    S, arrays = generator() if source == "generator" else parsed_chunk()
    dp = jax.jit(functools.partial(to._dp_parse, S=S,
                                   ladder=to.LEN_LADDER_DENSE))
    dc = to._dist_cost
    want = []
    for b in range(arrays[0].shape[0]):
        a = [jnp.asarray(x[b], jnp.int32) for x in arrays]
        want.append(dp(a[0], a[1], a[2], dc(a[2]), a[3], a[4], dc(a[4]),
                       a[5], a[6], dc(a[6]), a[7], dc(a[7]),
                       jnp.asarray(to._SEED_LC_LEN)))
    t = [torch.from_numpy(x.astype(np.int64)) for x in arrays]
    dct = optimal.dist_cost
    args = (t[0], t[1], t[2], dct(t[2]), t[3], t[4], dct(t[4]), t[5], t[6],
            dct(t[6]), t[7], dct(t[7]), torch.from_numpy(to._SEED_LC_LEN),
            S, kernels.LEN_LADDER_DENSE)
    span, dist = kernels.dp_parse_plain(*args)
    assert np.array_equal(span.numpy(), np.stack([np.asarray(w[0])
                                                  for w in want]))
    assert np.array_equal(dist.numpy(), np.stack([np.asarray(w[1])
                                                  for w in want]))
    # the wrapper on CPU tensors is the plain version
    s2, d2 = kernels.dp_parse(*args)
    assert torch.equal(s2, span) and torch.equal(d2, dist)
    assert (span > 1).any()
    if source == "parsed chunk":
        # where no tail edge reaches the segment end, a span is a rung or
        # 1, and rungs of the ladder's sparse top (past 34) are taken
        far = torch.arange(span.shape[1]) % S < S - 258
        taken = set(span[:, far].unique().tolist())
        assert taken <= set(kernels.LEN_LADDER_DENSE) | {1}
        assert taken & set(kernels.LEN_LADDER_DENSE[32:])


def pallas_dense(arrays, lc):
    """(span, dist) of interpret-mode Pallas at LEN_LADDER_DENSE, each
    chunk under its own lc row."""
    a = [jnp.asarray(x.astype(np.int32)) for x in arrays]

    def run(row):
        lc_b = np.stack([row] * crafted_dp.DP_B).astype(np.int32)
        s, d = dp_parse_pallas(*a, jnp.asarray(lc_b), S=crafted_dp.DP_S,
                               interpret=True, ladder=to.LEN_LADDER_DENSE)
        return np.asarray(s), np.asarray(d)

    if lc.ndim == 1:
        return run(lc)
    both = [run(lc[b]) for b in range(crafted_dp.DP_B)]
    return tuple(np.stack([both[b][k][b] for b in range(crafted_dp.DP_B)])
                 for k in range(2))


@pytest.mark.parametrize("name", list(SETS))
def test_plain_dp_matches_pallas_on_dense_ladder(name):
    arrays, lc = SETS[name]
    want_s, want_d = pallas_dense(arrays, lc)
    span, dist = kernels.dp_parse_plain(
        *[torch.from_numpy(x) for x in arrays], torch.from_numpy(lc),
        crafted_dp.DP_S, kernels.LEN_LADDER_DENSE)
    assert np.array_equal(span.numpy(), want_s)
    assert np.array_equal(dist.numpy(), want_d)
