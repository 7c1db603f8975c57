"""The nine match-bias shapes of ``scripts/exp_match_bias.py`` and the
lean tier at depth 16 with a second cost pass (``exp_corpus2_breadth.py``'s
"lean-d16-p2") through the port, against the JAX package.

The shapes are the script's own (its ``f259`` and ``shapes``, taken from
its ``main`` by ``ast``), each a [259] vector of 16 times the shape's bits
rounded (``exp_match_bias.bias16``); the JAX side is the script's ``fn``,
``_compress_chunks_optimal_pallas`` in interpret mode with the bias
traced, so one compile serves all nine (``driver_cases.match_bias_fn``),
on ``tests/dp_tier_cases.py``'s batch of two 64 KiB chunks at B = 2 (one
cost pass: one [259] table for every chunk).  "lean-d16-p2" runs the
jitted JAX function on each chunk alone (B = 1: with a second cost pass
the Pallas DP reads one chunk's match costs for a 1024-lane block, the
port each chunk's own).  Words and total_bits equal, tolerance 0; every
stream inflates through zlib.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dp_tier_cases as dtc
import driver_cases as dc
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu_torch.experiments import exp_corpus2_breadth as cb
from libdeflate_tpu_torch.experiments import exp_match_bias as mb

one_torch_thread = dtc.one_torch_thread
FN = functools.lru_cache(maxsize=None)(dc.match_bias_fn)


def test_shapes_are_the_scripts():
    assert list(mb.SHAPES) == list(dc.BIAS_SHAPES)
    for name in mb.SHAPES:
        assert np.array_equal(mb.bias16(name), dc.bias16(name))
    assert mb.LEAN == {**dc.MATCH_BIAS, "ladder": mb.LEAN["ladder"]}
    assert tuple(mb.LEAN["ladder"]) == tuple(to.LEN_LADDER_DENSE2)


@pytest.mark.parametrize("name", list(dc.BIAS_SHAPES))
def test_bias_shape_equals_the_scripts(name):
    args = dtc.batch()
    want = FN()(*(jnp.asarray(x) for x in args),
                jnp.asarray(dc.bias16(name)))
    got = mb.CONFIGS[name](*args, device="cpu")
    dc.check_entry(got, tuple(np.asarray(x) for x in want), args[0], args[1])


def test_depth16_two_passes_equals_the_scripts():
    fn = jax.jit(functools.partial(dc.CORPUS2_VARIANTS["lean-d16-p2"],
                                   interpret=True))
    bufs, lengths, bfinal = dtc.batch()
    outs = [fn(*(jnp.asarray(x[k:k + 1]) for x in (bufs, lengths, bfinal)))
            for k in range(2)]
    want = (np.concatenate([np.asarray(w) for w, _ in outs]),
            np.concatenate([np.asarray(t) for _, t in outs]))
    got = cb.CONFIGS["lean-d16-p2"](bufs, lengths, bfinal, device="cpu")
    dc.check_entry(got, want, bufs, lengths)
