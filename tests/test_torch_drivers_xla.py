"""Configurations of ``scripts/ratio_ab.py`` and ``scripts/exp_r5_speed.py``
that no pin covered before, through the port, against the JAX package:
the second stride round cut to (32, 64, 128) and left out, with raw C
(``ext_c=False``), and left out with 4 refinement passes
(``ratio_ab``'s "ext2shrink", "ext2none", "ext2none+refine4": the
script's ``one``, ``parse_chunk_optimal`` and ``emit_dynamic_block``
over the batch, its variants taken by ``ast``, run stage by stage with
one compile a stage for the three, ``driver_cases.stagewise_ratio_ab``);
and the dynamic
tier with 8-byte payloads at depth 8 (``exp_r5_speed``'s "dyn-lcp8-d8":
``_compress_chunks_dynamic_pallas`` in interpret mode).  On
``tests/dp_tier_cases.py``'s batch of two 64 KiB chunks (SURVEY.md text,
records 40000 bytes long), bfinal mixed.  Words and total_bits equal,
tolerance 0; every stream inflates through zlib.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dp_tier_cases as dtc
import driver_cases as dc
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu_torch.experiments import exp_r5_speed as r5
from libdeflate_tpu_torch.experiments import ratio_ab

one_torch_thread = dtc.one_torch_thread
RATIO_AB = functools.lru_cache(maxsize=None)(dc.stagewise_ratio_ab)
CASES = {f"ratio_ab/{k}": (ratio_ab.CONFIGS[k],
                           lambda _k=k: functools.partial(RATIO_AB(), _k))
         for k in ("ext2shrink", "ext2none", "ext2none+refine4")}
CASES["exp_r5_speed/dyn-lcp8-d8"] = (
    r5.CONFIGS["dyn-lcp8-d8"],
    lambda: jax.jit(functools.partial(td._compress_chunks_dynamic_pallas,
                                      interpret=True, lcp=8,
                                      **{**dc.R5_DYN, "depth": 8})))


def test_variants_are_the_scripts():
    assert list(ratio_ab.VARIANTS) == list(dc.RATIO_AB)
    for name, (kw, refine) in dc.RATIO_AB.items():
        assert ratio_ab.VARIANTS[name] == (kw, refine)


@pytest.mark.parametrize("name", CASES)
def test_configuration_equals_the_scripts(name):
    port_fn, make = CASES[name]
    args = dtc.batch()
    want = make()(*(jnp.asarray(x) for x in args))
    got = port_fn(*args, device="cpu")
    dc.check_entry(got, tuple(np.asarray(x) for x in want), args[0], args[1])
