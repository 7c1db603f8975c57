"""``compress_chunks_optimal_with(row_lit1=True, lcp=12)`` and
``compress_chunks_dynamic_with(lcp=8, depth=4)`` against the JAX
package's XLA path.

``libdeflate_tpu_torch.compress_chunks_optimal_with`` with
``scripts/ratio_ab.py``'s "rowlit+lcp12" keywords (one cost pass, no
content pass, 16-byte payloads cut to 8 by ``lcp`` 12, raw C, the
80-rung ladder, pass 1's literal cost the mean of each 64 KiB row of
every byte, 16 refinement passes) against
``libdeflate_tpu/compress/tpu_optimal.py::compress_chunk_optimal`` under
vmap on one 128 KiB chunk of text then noisy records (two rows of
different costs).  Words and total_bits exact; the fragment inflates to
its chunk.  As in the reference, ``lcp`` 12 gives ``lcp`` 8's bits.

``libdeflate_tpu_torch.compress_chunks_dynamic_with(lcp=8, depth=4)``
(``scripts/exp_r5_speed.py``'s dyn-lcp8-d4: the lazy parse over 8-byte
matchfind payloads, four probes, 128 KiB windows, 11-bit codes) against
``libdeflate_tpu/compress/tpu_dynamic.py::compress_chunk_dynamic(lcp=8,
depth=4)`` under vmap, on tests/dp_tier_cases.py's batch (two 64 KiB
chunks, 65536 and 40000 live bytes, bfinal mixed); the three dynamic
tiers go through the same entry (``dynamic.TIERS``).  Words and
total_bits exact; every fragment inflates to its chunk.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np

import libdeflate_tpu_torch as lt
from dp_tier_cases import N, P1, batch, one_torch_thread  # noqa: F401
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu_torch.compress import dynamic

ROWLIT_LCP12 = dict(P1, row_lit1=True, lcp=12)


def test_row_lit1_lcp12_xla():
    bufs = batch()[0]
    one = np.concatenate([bufs[0], bufs[1]])[None].copy()
    args = (one, np.array([2 * N], np.int32), np.array([True]))
    want = jax.jit(jax.vmap(lambda b, l, f: to.compress_chunk_optimal(
        b, l, f, **ROWLIT_LCP12)))(*(jnp.asarray(x) for x in args))
    opts = {k: v for k, v in ROWLIT_LCP12.items() if k != "ext_c"}
    words, total_bits = lt.compress_chunks_optimal_with(
        *args, device="cpu", ext_c=False, **opts)
    assert np.array_equal(total_bits.numpy(), np.asarray(want[1]))
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(want[0]))
    stream = lt.device_stream_to_bytes(words[0], total_bits[0])
    assert zlib.decompressobj(-15).decompress(stream) == one[0].tobytes()
    w8, t8 = lt.compress_chunks_optimal_with(
        *args, device="cpu", **dict(P1, row_lit1=True, lcp=8))
    assert np.array_equal(w8.numpy(), words.numpy())


def test_dynamic_with_lcp8_depth4():
    args = batch()
    want = jax.jit(jax.vmap(functools.partial(
        td.compress_chunk_dynamic, lcp=8, depth=4)))(
        *(jnp.asarray(x) for x in args))
    words, total_bits = lt.compress_chunks_dynamic_with(
        *args, device="cpu", lcp=8, depth=4)
    assert np.array_equal(total_bits.numpy(), np.asarray(want[1]))
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(want[0]))
    bufs, lengths, _ = args
    for k in range(2):
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()


def test_dynamic_tiers_are_keywords_of_the_entry():
    assert dynamic.TIERS == {"dyn1": {}, "dyn2": dict(two_pass=True),
                             "dyn3": dict(two_pass=True, depth=12,
                                          hash3=True)}
    # the quality tiers' options as _compress_chunks_dynamic_pallas sets
    # them: the A/B extension follows two_pass or hash3
    opts, refine = dynamic.greedy_options(hash3=True)
    assert opts["wide_ext"] and not opts["wide_window"] and refine == 16
    opts, refine = dynamic.greedy_options()
    assert not opts["wide_ext"] and opts["wide_window"] and refine == 0
