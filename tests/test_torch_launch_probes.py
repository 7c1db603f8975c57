"""The port's launch probes (K5, K6, K7) against the Pallas kernels, on the CPU.

libdeflate_tpu_torch/experiments/exp_launch_overhead.py (``grid_add_one``,
``loop_add_one``) and exp_device_roundup.py (``grid_copy``) with CPU
tensors, so their plain versions ``x + 1`` and ``x.clone()``, against the
``pl.pallas_call``s of scripts/exp_pallas_overhead.py (``copy_kernel`` over a
grid, lines 27-41; ``loop_kernel`` in one step, lines 55-66) and of
scripts/exp_device_roundup.py section 1 (``empty_kernel``, every step
mapped to block (0, 0), lines 62-75), run with ``interpret=True``.
``loop_kernel`` and ``empty_kernel`` are nested in their scripts' ``main``,
so they are restated here as written there.  ``loop_add_one`` is also
held against numpy's wrapping ``x + 1`` at tile counts other than 256
(``loop_kernel`` is fixed at 256).

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from libdeflate_tpu_torch.experiments import exp_device_roundup as rd
from libdeflate_tpu_torch.experiments import exp_launch_overhead as lo
from scripts.exp_pallas_overhead import copy_kernel


def _grid_ref(x, n_steps, rows):
    """make_grid_fn's pallas_call (scripts/exp_pallas_overhead.py:31-41)."""
    return pl.pallas_call(
        copy_kernel, grid=(n_steps,),
        in_specs=[pl.BlockSpec((rows, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((rows, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_steps * rows, 128), jnp.int32),
        interpret=True)(x)


def _loop_ref(x):
    """main's g and loop_kernel (scripts/exp_pallas_overhead.py:55-66)."""
    def loop_kernel(x_ref, o_ref):
        def body(i, _):
            o_ref[pl.ds(i * 8, 8), :] = x_ref[pl.ds(i * 8, 8), :] + 1
            return 0
        jax.lax.fori_loop(0, 256, body, 0)

    return pl.pallas_call(
        loop_kernel,
        out_shape=jax.ShapeDtypeStruct((256 * 8, 128), jnp.int32),
        interpret=True)(x)


def _copy_ref(x, steps):
    """Section 1's pallas_call and empty_kernel
    (scripts/exp_device_roundup.py:62-75)."""
    def empty_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        empty_kernel, grid=(steps,),
        in_specs=[pl.BlockSpec((128, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((128, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        interpret=True)(x)


def _ints(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), (1 << 31) - 1, shape, dtype=np.int32)


@pytest.mark.parametrize("n_steps", [1, 8, 64])
def test_grid_add_one_matches_pallas(n_steps):
    x = _ints((n_steps * lo.ROWS, lo.LANES), n_steps)
    want = np.asarray(_grid_ref(jnp.asarray(x), n_steps, lo.ROWS))
    lo.reset_launch_counts()
    got = lo.grid_add_one(torch.from_numpy(x))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert lo.grid_add_one.launches == 0


def test_loop_add_one_matches_pallas():
    x = _ints((lo.LOOP_TILES * lo.ROWS, lo.LANES), 7)
    want = np.asarray(_loop_ref(jnp.asarray(x)))
    lo.reset_launch_counts()
    got = lo.loop_add_one(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    assert lo.loop_add_one.launches == 0


@pytest.mark.parametrize("ntiles", [1, 7, 133, 1000])
def test_loop_add_one_wraps_at_other_tile_counts(ntiles):
    """The tile counts the persistent wave finds hard (fewer tiles than
    SMs, a ragged last pass), both ends of int32 included: x + 1 wraps."""
    x = _ints((ntiles * lo.ROWS, lo.LANES), ntiles)
    x.reshape(-1)[::97] = np.iinfo(np.int32).max
    x.reshape(-1)[1::101] = np.iinfo(np.int32).min
    lo.reset_launch_counts()
    got = lo.loop_add_one(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), x + np.int32(1))
    assert got.numpy().reshape(-1)[0] == np.iinfo(np.int32).min
    assert lo.loop_add_one.launches == 0


@pytest.mark.parametrize("steps", [1, 16])
def test_grid_copy_matches_pallas(steps):
    x = np.random.default_rng(steps).standard_normal(rd.TILE).astype(
        np.float32)
    want = np.asarray(_copy_ref(jnp.asarray(x), steps))
    rd.reset_launch_counts()
    got = rd.grid_copy(torch.from_numpy(x), steps)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert rd.grid_copy.launches == 0


@pytest.mark.parametrize("case", ["dtype", "lanes", "rows", "strided"])
def test_add_one_wrappers_reject_bad_inputs(case):
    x = torch.zeros(16, 128, dtype=torch.int32)
    if case == "dtype":
        x = x.to(torch.int64)
    elif case == "lanes":
        x = torch.zeros(16, 64, dtype=torch.int32)
    elif case == "rows":                 # not a whole number of tiles
        x = torch.zeros(12, 128, dtype=torch.int32)
        with pytest.raises(ValueError):
            lo.grid_add_one(torch.zeros(16, 128, dtype=torch.int32), 3)
    else:
        x = torch.zeros(128, 16, dtype=torch.int32).T
    for fn in (lo.grid_add_one, lo.loop_add_one):
        with pytest.raises(ValueError):
            fn(x)


def test_grid_copy_rejects_bad_inputs():
    with pytest.raises(ValueError):
        rd.grid_copy(torch.zeros(4, 4, dtype=torch.float64), 1)
    with pytest.raises(ValueError):
        rd.grid_copy(torch.zeros(4, 4), 0)
    with pytest.raises(ValueError):
        rd.grid_copy(torch.zeros(8, 8).T, 1)


@pytest.mark.parametrize("n,steps,offset", [
    (1, 1, 0), (3, 64, 1), (4097, 2000, 0), (16385, 16, 1),
    (1 << 20, 64, 0), (1 << 20, 1, 1), (rd.TILE[0] * rd.TILE[1], 5000, 1)])
def test_grid_copy_contract(n, steps, offset):
    """The sizes chip_smoke.py holds the kernel to on the card: a tail
    that is not a multiple of 4 floats, a view one float into its buffer,
    more blocks than 16-byte pieces.  On the CPU, a copy of x."""
    buf = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n + 1).astype(np.float32))
    x = buf[offset:offset + n]
    assert x.is_contiguous() and x.storage_offset() == offset
    rd.reset_launch_counts()
    got = rd.grid_copy(x, steps)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert rd.grid_copy.launches == 0


@pytest.mark.parametrize("case", ["empty", "too many", "int32",
                                  "steps below 1"])
def test_grid_copy_refuses(case):
    x = {"empty": torch.zeros(0), "too many": torch.zeros((1 << 20) + 1),
         "int32": torch.zeros(16, dtype=torch.int32)}.get(case,
                                                          torch.zeros(16))
    with pytest.raises(ValueError):
        rd.grid_copy(x, -1 if case == "steps below 1" else 1)
