"""Configurations of the ported ratio drivers that no pin covered before,
against the JAX package: the probe depths 10, 16 and 24
(``pipeline.py:209``, ``:229``, ``:254`` run at each), depth 16 with
hash3 and with the rescue pass, the lean tier with the content pass (its
``_pool_probe`` loop at depth 4 and 8), and ``scripts/exp_r5_speed.py``'s
first stride rounds (1, 2, 8, 32, 128) and (1, 4, 16, 128).

Each is the port's entry from its driver's ``CONFIGS`` against
``_compress_chunks_optimal_pallas`` with the keywords the script gives it
(``scripts/exp_corpus2_breadth.py``'s ``variants()``, taken by ``ast``;
``exp_r5_speed.py``'s strides), run stage by stage in interpret mode
(``driver_cases.stagewise_pallas``: one compile a stage for all cases of
the file, the candidates op by op), on ``tests/dp_tier_cases.py``'s batch
of two 64 KiB chunks (SURVEY.md text, records 40000 bytes long), bfinal
mixed, at B = 2 (one cost pass: one [259] cost table for every chunk).
Words and total_bits equal, tolerance 0; every stream inflates through
zlib.  Depth 16 with two cost passes and the bias shapes are in
``tests/test_torch_drivers_bias.py``.
"""

import functools

import pytest

import dp_tier_cases as dtc
import driver_cases as dc
from libdeflate_tpu_torch.experiments import exp_corpus2_breadth as cb
from libdeflate_tpu_torch.experiments import exp_r5_speed as r5

one_torch_thread = dtc.one_torch_thread
RUN = functools.lru_cache(maxsize=None)(dc.stagewise_pallas)
CASES = {name: (cb.CONFIGS[name], dict(dc.CORPUS2_VARIANTS[name].keywords))
         for name in ("lean-d10", "lean-d16", "lean-d24", "lean-d16-h3",
                      "lean-d16-2p", "lean-content", "lean-d12-content")}
CASES["lean-s5"] = (r5.CONFIGS["lean-s5"],
                    dict(dc.R5_LEAN, strides1=(1, 2, 8, 32, 128)))
CASES["lean-s4"] = (r5.CONFIGS["lean-s4"],
                    dict(dc.R5_LEAN, strides1=(1, 4, 16, 128)))


@pytest.mark.parametrize("name", CASES)
def test_configuration_equals_the_scripts(name):
    port_fn, jax_kw = CASES[name]
    dc.check_stagewise(RUN(), port_fn, jax_kw, dtc.batch())
