"""The port's soak harness (``libdeflate_tpu_torch/experiments/soak.py``)
against ``scripts/tpu_soak.py`` and the JAX package.

- The payloads: ``soak.draw_batches`` gives ``scripts/tpu_soak.py``'s
  payloads (its own ``gen_payload`` and draw of lengths) byte for byte
  over a few seeds and sizes.
- The tiers: soak runs of static, dyn1 and dyn3 at B = 2 x 64 KiB (random
  lengths, all five payload classes, BFINAL on the even chunks) on the
  CPU, each call's words and total_bits held equal to the JAX package's
  XLA entry on the same batch, and every chunk through the soak's own
  checks (zlib, the plain K3 and F1 decoders, a fragment that is not
  final closed by an empty final block).
- The pins: ``soak_pins.json``'s recipe, lengths and payload digests equal
  what ``chip_smoke.py``'s soak phase draws, so the two cannot drift.
- The command line: the script's flags and defaults, and no device path
  without CUDA unless ``device="cpu"`` is asked for.

Tolerance: exact.
"""

import hashlib
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch.experiments import soak
from tests import pin_soak

N = 1 << 16
JAX = {"static": tp.compress_chunks_static,
       "dyn1": td.compress_chunks_dynamic,
       "dyn3": td.compress_chunks_dynamic3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: torch's OpenMP regions
    on [B, 64 KiB] tensors slow down by orders of magnitude when the
    suite's parallel workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,batches,b,n", [
    (soak.SEED, 6, 4, 4096), (1, 5, 3, 300), (2, 10, 1, 20000)])
def test_payloads_equal_the_script(seed, batches, b, n):
    ours = list(soak.draw_batches(batches, seed, b, n))
    theirs = list(pin_soak.script_payloads(batches, seed, b, n))
    assert ours == theirs
    lengths = [len(p) for batch in ours for p in batch]
    assert max(lengths) == n and min(lengths) < n


def _against_jax(seen):
    """A soak ``call`` that runs the port's entry and holds its words and
    total_bits to the JAX package's XLA entry on the same batch."""
    def call(tier, entry, bufs, lens, bfinal):
        words, total_bits = entry(bufs, lens, bfinal)
        w_j, t_j = JAX[tier](jnp.asarray(bufs.numpy()),
                             jnp.asarray(lens.numpy(), jnp.int32),
                             jnp.asarray(bfinal.numpy()))
        assert np.array_equal(total_bits.numpy(), np.asarray(t_j)), tier
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(w_j)), tier
        seen.append((tier, lens.tolist(), bfinal.tolist()))
        return words, total_bits
    return call


@pytest.mark.parametrize("seed", [soak.SEED, 5])
def test_soak_draws_equal_jax(seed):
    seen = []
    res = soak.run(3, seed, tuple(JAX), device="cpu", b=2, n=N,
                   call=_against_jax(seen), log=lambda line: None)
    assert [t for t, _, _ in seen] == list(JAX)
    assert res["chunks"] == 6 and res["tiers"] == list(JAX)
    assert res["lengths"] == [lens for _, lens, _ in seen]
    assert all(bf == [True, False] for _, _, bf in seen)


def test_short_chunks_equal_jax():
    """Chunks of 0-258 bytes in 64 KiB rows, two a batch."""
    seen = []
    call = _against_jax(seen)
    short = soak.short_payloads()
    for tier in JAX:
        for i in range(0, len(short), 2):
            soak.soak_batch(tier, short[i:i + 2], torch.device("cpu"), N,
                            call)
    assert len(seen) == len(JAX) * len(short) // 2
    assert [len(p) for p in short] == list(soak.SHORT_LENGTHS)


def test_pins_recipe_equals_chip_smoke():
    pins = json.loads(soak.PINS.read_text())
    rec = soak.recipe(chip_smoke.SOAK_BATCHES, chip_smoke.SOAK_SEED,
                      soak.TIERS)
    assert pins["recipe"] == rec
    assert rec["batches"] == 2 * len(soak.TIERS) and rec["B"] == 4
    assert rec["N"] == 1 << 20 and rec["seed"] == 0xF00D
    lengths, digests = [], []
    for payloads in soak.draw_batches(rec["batches"], rec["seed"]):
        lengths.append([len(p) for p in payloads])
        digests.append([hashlib.sha256(p).hexdigest()
                        for p in payloads])
    assert pins["lengths"] == lengths
    assert pins["payload_sha256"] == digests
    for key in ("total_bits", "sha256"):
        assert [len(row) for row in pins[key]] == [4] * rec["batches"]
    # every tier's chunks hold short, long and full lengths of all classes
    assert min(map(min, lengths)) < 1 << 16 and max(map(max, lengths)) \
        == 1 << 20


def test_command_line_and_device():
    src = (pin_soak.REPO / "scripts" / "tpu_soak.py").read_text()
    assert '"--batches", type=int, default=6' in src
    assert '"--seed", type=int, default=0xF00D' in src
    assert (soak.BATCHES, soak.SEED, soak.B, soak.N) == (6, 0xF00D, 4,
                                                        1 << 20)
    assert soak.parse_tiers("static,dyn1,dyn3") == soak.DEFAULT_TIERS
    assert soak.parse_tiers("all") == tuple(soak.TIERS) and len(
        soak.TIERS) == 9
    with pytest.raises(ValueError):
        soak.parse_tiers("dyn4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            soak.run(1, b=1, n=64)
        with pytest.raises(RuntimeError):
            soak.main(["--batches", "1"])
    with pytest.raises(ValueError):
        soak.run(1, device="cpu", b=1, n=64,
                 pins={"recipe": soak.recipe(2, soak.SEED, soak.TIERS)})


def test_final_tail_closes_a_fragment():
    """A fragment that is not final (a sync flush at its end) and the empty
    final block after it form one stream."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    frag = c.compress(b"soak " * 50) + c.flush(zlib.Z_SYNC_FLUSH)
    d = zlib.decompressobj(-15)
    assert d.decompress(frag + soak.FINAL_TAIL) == b"soak " * 50 and d.eof
