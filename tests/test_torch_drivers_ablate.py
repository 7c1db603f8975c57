"""The port's ablations of the lean tier (``libdeflate_tpu_torch/
experiments/ablate_lean.py``) against ``scripts/ablate_lean.py``'s own
``lean_pipeline``, taken from its source by ``ast`` (importing the script
builds the bench corpus) with ``dp_parse_pallas`` and
``pack_groups_pallas`` in interpret mode.

All eight ablations on both chunks of ``tests/dp_tier_cases.py``'s batch
cut to 16 KiB (SURVEY.md text, and records 12000 bytes long), not
final.  The
port runs the batch at B = 2; the script's pipeline runs each chunk alone
(B = 1): with a second cost pass the Pallas DP reads one chunk's match
costs for a 1024-lane block, the port each chunk's own, as the XLA
entries do (queue 3 of ROADMAP.md).  The script's pipeline runs stage by
stage, each stage jitted once for all ablations (``StageJit``: the
floating-point literal costs stay inside one jitted stage), which keeps
the JAX compiles to one a stage instead of one a whole pipeline.  Words
and total_bits equal, tolerance 0; the unablated streams inflate through
zlib.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dp_tier_cases as dtc
import driver_cases as dc
import libdeflate_tpu_torch as lt
from libdeflate_tpu_torch.experiments import ablate_lean

one_torch_thread = dtc.one_torch_thread
SCRIPT = dc.ablate_ns(dc.StageJit(), dc.jitted_kernels())
ARGS = dtc.small_batch(1 << 14, (1 << 14, 12000))


@functools.lru_cache(maxsize=None)
def jax_out(name, k):
    bufs, lengths, bfinal = ARGS
    ab = () if name == "none" else (name,)
    w, t = SCRIPT["lean_pipeline"](jnp.asarray(bufs[k:k + 1]),
                                   jnp.asarray(lengths[k:k + 1]),
                                   jnp.asarray([False]), ab)
    return np.asarray(w)[0], int(np.asarray(t)[0])


def test_ablations_are_the_scripts():
    assert ablate_lean.ABLATIONS == SCRIPT["ABLATIONS"]
    assert ablate_lean.DEPTH == SCRIPT["DEPTH"]
    assert ablate_lean.LADDER == SCRIPT["LADDER"]


@pytest.mark.parametrize("name", ablate_lean.ABLATIONS)
def test_ablation_equals_the_scripts_pipeline(name):
    bufs, lengths, _ = ARGS
    words, total_bits = ablate_lean.lean_pipeline(
        torch.from_numpy(bufs.copy()), torch.as_tensor(lengths, dtype=torch.int64),
        torch.zeros(2, dtype=torch.bool), ablate_lean.ablation(name))
    for k in range(2):
        w_j, t_j = jax_out(name, k)
        assert int(total_bits[k]) == t_j
        assert np.array_equal(words[k].numpy().view(np.uint32), w_j)
        if name not in ("pack",):
            stream = lt.device_stream_to_bytes(words[k], total_bits[k])
            assert zlib.decompressobj(-15).decompress(stream) == \
                bufs[k, :lengths[k]].tobytes()
