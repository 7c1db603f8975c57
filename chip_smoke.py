"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--against F]

``--against F`` also times F, an earlier ``csrc/fsm_decode.cu`` (F1), in
turns beside the as-built kernel on the FSM main path's streams; without
it F1's ``parent_ms`` is null.  It builds the port's CUDA kernels from ``libdeflate_tpu_torch/csrc``,
holds each kernel against its plain version on the card (random inputs
and the main paths' real inputs, exact equality), and drives the port's
two paths through their entry points:

- the loop kernels (``scan_phase``): C1, the commit FSM
  (``csrc/commit_fsm.cu``), and C2, the code-length build
  (``csrc/code_lens.cu``), each of which replaces a ``lax.scan`` of the
  JAX package, equal to their plain versions (the torch loops) on every
  commit of a lean pass (seg 1024) and a dyn1 pass (seg 512), one lane a
  chunk (lean on 99 800 and 2 500 bytes, dyn1 on 300), random-length
  chunks of the soak payload classes through lean and dyn1, every build
  of a lean, an optfast and a dyn2 pass, and the crafted sets of
  ``experiments/crafted_scan.py`` (segments of 512, 1024, 2600 and 4608;
  rows of 286, 30 and 512 symbols); one kernel node a wrapper call in a
  CUDA graph; each timed beside its plain version, the torch loop, in
  turns;
- the chain extension (``chain_phase``): C3, the multi-stride relaxation
  (``csrc/chain_extend.cu``'s ``chain_relax``), and C4, the stride-8
  doubling (``chain_double``), which replace XLA code of the JAX
  package's candidate stage, equal to their plain versions on the card
  on every call of one batch of lean, optfast, optimal, deep, static,
  dyn1, dyn2 and dyn3 (their rescue passes too), on the scripts' lean
  triples at every stride set the repository passes, on
  ``experiments/crafted_chain.py``'s sets and shapes at tiles of 64, 256
  and 1024 positions, and on 66000 rows; one kernel node a wrapper call
  in a CUDA graph; each timed beside its plain version in turns.  No
  compress path may run the plain chain extensions on CUDA tensors
  (``guard_plain_chain``), and
  every tier's launch counts show C3 on each DP call and C4 on each
  greedy call and rescue pass;
- the sorted matchfind's probes (``probe_phase``): C5
  (``csrc/segment_probe.cu``), which replaces the XLA code of the JAX
  package's ``_sorted_matchfind`` after its sort, equal to its plain
  versions (``probe_kernels.sorted_best``,
  ``probe_kernels.sorted_matchfind_lean``) on every call of one batch of
  each tier, on ``experiments/crafted_probe.py``'s sets at every (form,
  depth, width) the callers run and at depth 32, and at 64 x 1 MiB in
  each form, timed there beside its plain version in turns, the sort and
  its bound.  No
  compress path may run those plain versions on CUDA tensors
  (``guard_plain_probe``), and every tier's, option's, whole-file, mesh,
  soak and drivers launch count shows C5 once a static, dyn1, lean,
  optfast and level 5-7 call and once a rescue pass;
- compress: lean min-cost-DP raw-DEFLATE compress of a 16 MiB corpus in
  1 MiB chunks, 4 chunks per call, through ``compress_chunks_lean``; K1,
  K2, C1 and C2 each launched; every chunk round-trips through zlib, and
  one chunk's CUDA output equals the CPU output;
- greedy tiers: the same corpus and batches through
  ``compress_chunks_static``, ``compress_chunks_dynamic``,
  ``compress_chunks_dynamic2`` and ``compress_chunks_dynamic3``: one pack
  launch (K2), one C1 and (but static) one C2 a call and no DP, every
  chunk inflates through zlib, every chunk's total_bits equals the JAX
  package's (pinned in
  ``experiments/greedy_total_bits.json`` by
  ``tests/pin_greedy_total_bits.py``), CUDA equals the CPU on chunk 0
  and a 40000-byte tail chunk, K2 equals its plain version on each
  tier's own inputs (capw + 1 = 38, 46, 62) and K3 decodes the dyn1 and
  static streams back; GB/s, ratio and stage ms per tier;
- DP tiers: the same corpus and batches through
  ``compress_chunks_optfast``, ``compress_chunks_optimal``,
  ``compress_chunks_optimal2``, ``compress_chunks_optimal_deep`` and
  ``compress_chunks_optimal_with`` at the mesh's level 5-7, 8-9 and
  10-12 keywords: K1, C1 and C2 launched once a cost pass and K2 once a
  call, every chunk inflates through zlib, every chunk's total_bits
  equals the JAX package's (pinned in ``experiments/dp_total_bits.json`` by
  ``tests/pin_dp_total_bits.py``), CUDA equals the CPU on chunk 0 and a
  40000-byte tail chunk for optfast and deep, K1 equals its plain
  version at both ladders (LEN_LADDER, LEN_LADDER_DENSE2) on every pass's
  own inputs of optfast, optimal, optimal2 and deep (the refined passes
  with a match-cost table a chunk), K2 on optfast's (capw + 1 = 62), and
  K3 decodes the optfast streams back; GB/s (optfast best of 3, optimal,
  optimal2 and deep one pass after a warm-up), ratio and stage ms;
- options (``options_phase``): the compress options only ``scripts/``
  reaches, through ``compress_chunks_optimal_pallas_with``,
  ``compress_chunks_optimal_with`` and ``compress_chunks_dynamic_with``
  on the same corpus, B = 4 a call, the chunks not final: leanD (the
  46-rung LEN_LADDER_DENSE), leanI (flat_lit1), lean1XR (row_lit1),
  lean1X8 and lean1XR8 (lcp 8), rowlit+lcp12, the deep tier with round
  probes, dyn-lcp8-d4, lean, lean with pm_group=64 and lean and leanD
  with emit_blocks=4: every chunk's total_bits equal to the JAX
  package's (pinned in ``experiments/option_total_bits.json`` by
  ``tests/pin_option_total_bits.py``), every chunk inflating through
  zlib, pm_group=64's words equal to lean's, K1 once a cost pass and K2
  once a call; GB/s and ratio a configuration; K1 at LEN_LADDER_DENSE
  held to its plain version and timed beside the other two ladders, K2
  at capw + 1 = 59, 62 and 24 beside index_add_;
- decode: the compress path's own streams, left on the card and padded
  there, and zlib level-6 streams of the same 16 chunks, each set decoded
  in one known-size ``decompress_chunks_words`` call of B = 16; the zlib
  set also through the unknown-size ``decompress_chunks``.  Every chunk
  must equal the corpus.  Before it, K3 is held against its plain version
  on the zlib-6, lean, Z_FIXED, damaged and run-on sets and on the K3
  sets of ``experiments/crafted_streams.py`` in both size modes (matches
  of every short distance, distance 32768, items across 32 KiB
  boundaries, long stored blocks, stored jumps to ring edges, output past
  out_bytes, failures in the middle of a window), and its chain is set
  beside its floor (the plain version's lookups under K3's own loop);
- whole file: ``gzip_compress_dp`` of the corpus over
  ``make_chunk_mesh()`` (every CUDA device; on one card, that card: B =
  16 x 1 MiB a call) at levels 0, 1, 6, 9 and 12: the gzip bytes' length and
  SHA-256 equal the JAX package's (pinned in
  ``experiments/file_codec_pins.json`` by ``tests/pin_file_codec.py``),
  every chunk's gathered size equals the pinned JAX total_bits, the
  output inflates through zlib, K2 launches once a call and K1 once a
  cost pass, K3 never; GB/s, the share of a call off the tier entries
  and peak memory; ``zlib_compress_dp`` and ``deflate_compress_dp`` at
  level 1 with zlib's checksums; ``compress_chunks_dp`` at level 6 with
  BFINAL on every chunk, then ``decompress_chunks_dp`` of its fragments
  and of the zlib-6 streams (decoder "auto": one K3 launch a shard and
  no F1 launch, every chunk equal, a corrupt chunk isolated, out_lens
  one short BAD_DATA) and of the fragments with decoder "fsm" (one F1
  launch a shard, no K3); ``entry()`` on the card equal to the CPU and
  ``dryrun_multichip(1)``;
- mesh (``mesh_phase``): shards at once on one card,
  ``make_chunk_mesh(["cuda:0"] * k)``, one worker thread and one stream a
  shard: gzip at the five levels for k = 2 and 4 (bytes equal to the
  pins, k times a shard's launches, each pass's K1 launches of the k
  shards as one batch and every K2 launch equal to the plain versions),
  ``decompress_chunks_dp`` at k = 4 with decoders "pallas" and "fsm"
  (every chunk equal to the corpus, one launch a shard), the whole-file
  times at k = 1, 2 and 4 at levels 1 and 6, and a ``device_trace`` of
  one level-6 call at k = 4 (idle share, streams that ran kernels, ms in
  which two or more ran at once); every kernel wrapper (K1-K7, F1, C1,
  C2) called from a worker thread on a side stream, equal to its plain
  version, its kernel on that stream in a trace (``side_stream_phase``);
  with more than one card, ``dryrun_multichip`` over every card, gzip
  level 6 over every card against its pin and the level-6 tier on
  cuda:1, else one line saying that part did not run;
- host contract: ``Compressor``, ``Decompressor``, ``crc32`` and
  ``adler32`` on the host engine, the native codec built from
  ``native/ldtpu_native.cpp`` into ``build/native/`` (asserted loaded)
  and then the forced Python path: the raw DEFLATE of the corpus at
  levels -1 to 12 and the three formats of its first 1 MiB (native), the
  first 256 KiB at levels 0-9 and 16 KiB at 10-12 (Python), equal the JAX
  package's bytes (pinned in ``experiments/host_engine_pins.json`` by
  ``tests/pin_host_engine.py``) and decode back in both size modes, with
  compress and decompress MB/s per level; K3 decodes every chunk's
  ``Compressor(l)`` stream at l = 1, 6, 12 (two chunks held to its plain
  version); the native and Python ``gzip_decompress`` decode
  ``gzip_compress_dp``'s level-6 output (K1, K2); the host checksums equal
  zlib's and the device's per chunk; the damaged set's ``Decompressor``
  4-tuples equal the pinned ones on both backends;
- FSM decoder (``fsm_phase``): F1 (``csrc/fsm_decode.cu``, the port of
  the JAX package's ``decompress/tpu.py``) equal to its plain version on
  the sets of ``experiments/fsm_cases.py`` (zlib levels and strategies,
  damaged, incomplete codes, crafted bounds, the edges of the kernel's
  root tables, input ring and window; B = 8 x 8 KiB), on K3's crafted
  sets as byte rows (out_cap 81920), on batches repacked into rows of
  8191 bytes (out_cap 16383) and on the 16 zlib-6 chunks, and every
  4-tuple of the damaged, incomplete, crafted and edge sets equal to the
  JAX package's (pinned in
  ``experiments/fsm_pins.json`` by ``tests/pin_fsm.py``); the main path:
  the 16 zlib-6 and 16 lean streams through ``fsm.decompress_chunks``,
  one B = 16 call each into 1 MiB rows, every chunk equal to the corpus,
  best of 3 beside K3's; F1's chain (the plain version's symbols and
  lookups); the programs on the corpus through their ``main``:
  ``gzip_cli --tpu -6`` (bytes equal to the level-6 pin), ``benchmark
  -C ours-tpu -D ours-tpu`` (F1) and ``-D ours-pallas`` (K3),
  ``checksum -T`` (zlib's values); a ``utils.profiling.device_trace``
  of one ``compress_chunks_lean`` call at B = 4, its top device ops by
  self time and the device's idle share over the traced window;
- randomized harnesses (``soak_fuzz_phase``): ``experiments/soak.py``
  (the port of ``scripts/tpu_soak.py``) through all nine compress tiers,
  two batches a tier of four chunks of random length up to 1 MiB of the
  script's five payload classes (seed 0xF00D, 72 chunks): every chunk
  through zlib, K3 and F1 back to its payload and equal to the JAX
  package's total_bits and SHA-256 (pinned in
  ``experiments/soak_pins.json`` by ``tests/pin_soak.py``), every K2, C1
  and C2 call of the soak and K1's calls on the first batch of each DP
  tier held to their plain versions; chunks of 0-258 bytes in 1 MiB rows
  through every tier, every kernel call held to its plain version;
  ``experiments/fuzz.py`` (the port of ``scripts/fuzz.py``, seed 0): 24
  trials of the host targets on the native codec and of the device
  target (an 8 KiB row through static and dyn1, its zlib-6 stream and
  three damaged copies through K3 in both size modes and F1, each
  decoder equal to its plain version) and an empty row, with the rows,
  lengths and device successes that zlib rejects printed;
- the measurement and ratio drivers of ``scripts/`` (``drivers_phase``),
  each in a short form: the stage profilers ``profile_lean`` and
  ``profile_opt`` (reps 1, B = 4 x 1 MiB; the profiled chain's stream
  through zlib and K3 back to the input), ``ablate_lean``'s eight
  ablations on the corpus's first batch, ``probe_prims``, every
  configuration of ``ratio_ab``, ``exp_corpus2_breadth``,
  ``exp_match_bias``, ``exp_r5_speed``, ``exp_dp_corpus`` and
  ``exp_ratio_gap`` on the first 1 MiB chunk of the corpus and of the
  second corpus's text (``experiments/corpus.py::make_corpus2``), the
  ablations' and configurations' total_bits and SHA-256 equal to the JAX
  package's (pinned in ``experiments/ratio_total_bits.json`` by
  ``tests/pin_ratio_drivers.py``) and every stream through zlib,
  ``exp_ratio_gap``'s re-costing equal to the pins, ``exp_text_gap_diag``
  on one chunk, and the checksum probes on 64 x 1 MiB (every row equal to
  zlib's; K3 on 16 zlib-6 chunks; the CRC's sub-stages in a CUDA graph);
  a recorded K1, K2, C1 and C2 call of each profiler and of the unablated
  pipeline held to its plain version;
- measure: the device measurement roundup,
  ``experiments.exp_device_roundup.main``, at its full size: the launch
  probe (K7), CRC-32 and Adler-32 of 8 x 1 MiB (each equal to zlib), K3 on
  8 zlib-6 chunks, dyn1 and dyn2, optimal and deep over the corpus, the
  tokenize-only ceiling (K4 per corpus class beside K3's decode of the
  same streams) and the grid and loop probes (K5, K6).
  Before it, K4 is held against its plain version in all six
  configurations (the 16 zlib-6 chunks, Z_FIXED, the damaged and run-on
  sets, and the crafted sets of ``experiments/crafted_streams.py`` that
  the CPU tests hold against the JAX package), its store variants are
  checked in the SASS for their token stores, and K5-K7 against x + 1
  and x.clone() (K6 at 1 to 1000 tiles; K7 at 1 to 2**20 floats, a view
  one float into its buffer, more blocks than 16-byte pieces), and K5 is
  timed in turns beside the launch floor (an empty kernel on K5's grid),
  its earlier per-element design (built at run time), K6's kernel on
  its input and
  x + 1, each by graph replay.  K4's
  chain is set beside its floor: the plain version's table lookups of
  the chunk with the most tokens times the card's dependent
  shared-memory load latency, and K4's clock64() cycles per chunk in the
  table setups and the token loop.

K1 is held against its plain version on random inputs at the main path's
shape, the main path's own, the DP tiers' own, and at both ladders on
per-chunk lc tables at S = 256, 15 lanes (a ragged warp), one chunk, a
segment of 8704 positions (64-bit keys) and the crafted sets of
``experiments/crafted_dp.py`` (ties, caps exceeded,
fields past their packed bits, lengths past 258, all-literal chunks);
the nodes of a CUDA graph captured around one wrapper call show that it
runs its kernel and no other device op. K2 is held against its plain
version on random, main-path (the text, rand and runs parts of the
corpus, B = 4, 2 and 1; chunks that turn from dense to sparse data
inside them) and crafted inputs (every group on one start word, start
words near the end, sparse start words, a run of 40 groups a word before
sparse ones); the nodes of a CUDA graph captured around one wrapper call
show that it runs its kernel and no other device op. It times each
kernel beside its plain version: K1 (also as its bare launch), K3, K4
and F1 by CUDA events around back-to-back calls, K2 and K5-K7 (a few
microseconds each, less than their wrappers' host time) by replaying 200
calls from a CUDA graph, K2 also as its bare launch and on the rand,
runs and dense-then-sparse inputs beside index_add_. Any failure raises
and the script exits non-zero; without a CUDA device it exits non-zero
at once.

The last lines are a JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

CHUNK = 1 << 20
BATCH = 4
CORPUS_MB = 16
PART_CHUNKS = (0, 4, 8, 12, 15)  # one chunk of each corpus part
DAMAGED_CHUNK = 1 << 16
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
# integer adds and mins: 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper
# architecture white paper)
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# one dependent step a cycle at the SM's boost clock: the floor of a
# chain of steps that each need the one before
H100_CLOCK = 1.98e9
# what a feasible DP rung needs: cd + lc[f] + D[t+f] (two adds) and one min
DP_OPS_PER_RUNG = 3
LOOP_TILE_COUNTS = (1, 7, 133, 256, 1000)  # K6 checks; 256 is its main shape
COPY_SIZES = (1, 3, 4097, 16385, 1 << 20)  # K7 checks beside its 128 x 128 tile
GREEDY_BITS = "libdeflate_tpu_torch/experiments/greedy_total_bits.json"
DP_BITS = "libdeflate_tpu_torch/experiments/dp_total_bits.json"
FILE_PINS = "libdeflate_tpu_torch/experiments/file_codec_pins.json"
HOST_PINS = "libdeflate_tpu_torch/experiments/host_engine_pins.json"
FSM_PINS = "libdeflate_tpu_torch/experiments/fsm_pins.json"
OPTION_BITS = "libdeflate_tpu_torch/experiments/option_total_bits.json"
SOAK_PINS = "libdeflate_tpu_torch/experiments/soak_pins.json"
SOAK_SEED = 0xF00D          # scripts/tpu_soak.py's default seed
SOAK_BATCHES = 18           # two batches of each of the nine tiers
FUZZ_SEED = 0
FUZZ_ITERS = 24             # host trials, each also a device trial
# the launch floor beside K5: a kernel that does nothing, timed in turns
# with K5 and x + 1, FLOOR_TURNS turns of 200 graph-replayed launches each;
# beside them K5's earlier design (a block a tile, a thread an element,
# 4-byte loads), built here, and K6's kernel (a wave of SM-count blocks,
# 16 bytes a thread) on the same input
FLOOR_TURNS = 8
LAUNCH_FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
__global__ void add_one_elem_kernel(const int* __restrict__ x,
                                   int* __restrict__ o, int tile) {
  const size_t base = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    o[base + i] = x[base + i] + 1;
}
extern "C" int add_one_elem_launch(const int* x, int* o, int n_steps,
                                  int rows, void* stream) {
  const int tile = rows * 128;
  if (n_steps > 0)
    add_one_elem_kernel<<<n_steps, tile < 1024 ? tile : 1024, 0,
                         (cudaStream_t)stream>>>(x, o, tile);
  return (int)cudaGetLastError();
}
"""
HOST_BEST_OF_3 = (1, 6, 12)   # host contract levels timed best of 3
CROSS_LEVELS = (1, 6, 12)     # Compressor levels whose chunks K3 decodes
CROSS_PLAIN_CHUNKS = [0, 12]  # chunks K3 is held to its plain version on
# whole-file levels -> (the chunk pins' configuration, K1 launches a
# shard, best of 3 timed calls or one)
FILE_LEVELS = {0: ("static", 0, 1), 1: ("dyn1", 0, 3), 6: ("level5", 1, 3),
               9: ("level8", 2, 1), 12: ("level10", 2, 1)}
# C3's and C4's launches a call of a level's tier on one shard: the
# greedy tiers double, the DP tiers relax, level 12's rescue pass doubles
FILE_CHAIN = {0: {"chain_relax": 0, "chain_double": 1},
              1: {"chain_relax": 0, "chain_double": 1},
              6: {"chain_relax": 1, "chain_double": 0},
              9: {"chain_relax": 1, "chain_double": 0},
              12: {"chain_relax": 1, "chain_double": 1}}
# C5's launches a call of a level's tier on one shard: the greedy tiers'
# and level 6's main pass, level 12's rescue pass; level 9's 32-byte
# triple stays plain
FILE_PROBE = {0: 1, 1: 1, 6: 1, 9: 0, 12: 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_equal(name: str, got, want) -> int:
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            diff = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({diff} elements differ)")
    # bool tensors (C1's heads, C2's ok) have no difference of their own
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()
                   if g.dtype == torch.bool else (g - w).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def main_path_kernel_inputs(bufs, lengths):
    """The DP's and the pack's inputs for one batch, built by the same
    stage functions compress_chunks_lean calls."""
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import pipeline as pp
    bp, pos, lenA, dA, lenB, dB, lenC, dC, d3 = pp.parse_candidates_lean(
        bufs, lengths)
    cost_lit = po.literal_costs(bp, lengths,
                                po.literal_cost_table(bp, lengths))
    dp_args = (cost_lit, lenA, dA, po.dist_cost(dA), lenB, dB,
               po.dist_cost(dB), lenC, dC, po.dist_cost(dC), d3,
               po.dist_cost(d3), torch.as_tensor(po.SEED_LC_LEN,
                                                 device=bp.device))
    span, dist = pk.dp_parse(*dp_args, po.DP_SEG)
    cm, cl, eff = po.commit(span, dist, pos, lengths, po.DP_SEG)
    (val, nb, offs), _ = pd.emit_dynamic_pre(bp, cm, cl, eff, dist)
    sbuf, gw = pp.group_premerge(val, nb, offs, capw=pd.DYN_CAPW)
    return bp, dp_args, (sbuf, gw, pd.dyn_nwords(bufs.shape[1]))


def pack_random_inputs(dev, B=4, m=CHUNK // 128, seed=1):
    """The generator of the JAX package's pack kernel test
    (test_pack_kernel_matches_scatter) at the main path's group count."""
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import pipeline as pp
    rng = np.random.default_rng(seed)
    n = 128 * m
    nbits = rng.integers(1, 10, (B, n))
    values = rng.integers(0, 1 << 31, (B, n)) & ((1 << nbits) - 1)
    offs = np.cumsum(nbits, 1) - nbits
    nwords = int((offs[:, -1] + nbits[:, -1]).max() + 31) // 32 + 2
    sbuf, gw = pp.group_premerge(torch.as_tensor(values, device=dev),
                                 torch.as_tensor(nbits, device=dev),
                                 torch.as_tensor(offs, device=dev),
                                 capw=pd.DYN_CAPW)
    return sbuf, gw, nwords


def crafted_pack_inputs(gw: np.ndarray, nwords: int, capw1: int, dev,
                        seed: int):
    """(sbuf, gw, nwords) for given non-decreasing start words gw [B, m]:
    every bit of every word that some group's window [gw, gw + capw1)
    reaches below nwords goes to one random such group, or (half the
    time) to none, so the groups' bits are disjoint and nothing lies at
    or past nwords."""
    rng = np.random.default_rng(seed)
    B, m = gw.shape
    sbuf = np.zeros((B, m, capw1), np.int64)
    bits = np.int64(1) << np.arange(32, dtype=np.int64)
    for b in range(B):
        words = np.unique((gw[b][:, None] + np.arange(capw1)).reshape(-1))
        for w in words[words < nwords]:
            lo = np.searchsorted(gw[b], w - capw1 + 1)
            hi = np.searchsorted(gw[b], w, side="right")
            pick = rng.integers(lo - (hi - lo), hi, 32)
            use = pick >= lo
            np.bitwise_or.at(sbuf[b], (pick[use], w - gw[b][pick[use]]),
                             bits[use])
    return (torch.as_tensor(sbuf, device=dev), torch.as_tensor(gw, device=dev),
            nwords)


def dense_then_sparse_chunks(chunks: np.ndarray) -> dict:
    """Two batches of four 1 MiB chunks that change corpus class inside
    them, so that a run of dense groups (a few bits each) is followed by
    sparse ones.  Half and half: the zero half of the runs part then
    text, zeros then random bytes, text and "abcdefgh" runs alternating
    every 64 KiB, text then zeros (the reverse).  Mostly dense: 15/16
    zeros then text, 31/32 zeros then random bytes, 15/16 "abcdefgh"
    then text, 63/64 zeros with 8 KiB of text in the last 16 KiB.  Text
    is part 0 of the corpus, rand 6u, runs 7u (u = len(chunks) / 8)."""
    u = len(chunks) // 8
    text, rand, zeros, abc = (chunks[0], chunks[6 * u], chunks[7 * u],
                              chunks[8 * u - 1])
    half, cat = CHUNK // 2, np.concatenate
    seg = (np.arange(CHUNK) // (1 << 16)) % 2 == 1
    return {
        "half dense then sparse": np.stack([
            cat([zeros[:half], text[half:]]), cat([zeros[:half], rand[half:]]),
            np.where(seg, abc, text), cat([text[:half], zeros[half:]])]),
        "mostly dense then sparse": np.stack([
            cat([zeros[:-CHUNK // 16], text[:CHUNK // 16]]),
            cat([zeros[:-CHUNK // 32], rand[:CHUNK // 32]]),
            cat([abc[:-CHUNK // 16], text[:CHUNK // 16]]),
            cat([zeros[:-CHUNK // 64], text[:CHUNK // 128],
                 zeros[:CHUNK // 128]])])}


def index_add_call(sbuf, gw, nwords):
    """K2's library yardstick: a function making one index_add_ that adds
    every group word at its target, as group_place does (into an
    accumulator that is not cleared between calls: a measure of time)."""
    B, _, capw1 = sbuf.shape
    dev = sbuf.device
    tgt = torch.clamp(gw[..., None] + torch.arange(capw1, device=dev),
                      max=nwords - 1)
    tgt = (tgt + nwords * torch.arange(B, device=dev)[:, None, None]
           ).reshape(-1)
    acc = torch.zeros(B * nwords, dtype=torch.int64, device=dev)
    flat = sbuf.reshape(-1)
    return lambda: acc.index_add_(0, tgt, flat)


def max_shared_start(gw: torch.Tensor) -> int:
    """The most groups of one chunk that share a start word."""
    return max(int(torch.unique_consecutive(row, return_counts=True)[1].max())
               for row in gw.cpu())


def zlib6(raw: bytes, strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(raw) + c.flush()


def damaged_streams(chunks, seed=7):
    """32 damaged zlib streams of 64 KiB corpus slices, 8 sources x (bit
    flips, a byte overwrite, a cut in the middle, a cut of 1-3 bytes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        ci = PART_CHUNKS[i % len(PART_CHUNKS)]
        off = int(rng.integers(0, CHUNK - DAMAGED_CHUNK))
        raw = chunks[ci, off:off + DAMAGED_CHUNK].tobytes()
        s = zlib6(raw, zlib.Z_FIXED if i % 4 == 3 else
                  zlib.Z_DEFAULT_STRATEGY)
        for kind in range(4):
            b = bytearray(s)
            if kind == 0:
                for _ in range(int(rng.integers(1, 4))):
                    j = int(rng.integers(0, 8 * len(b)))
                    b[j // 8] ^= 1 << (j % 8)
            elif kind == 1:
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            elif kind == 2:
                b = b[:int(rng.integers(1, len(b)))]
            else:
                b = b[:len(b) - int(rng.integers(1, 4))]
            out.append(bytes(b))
    return out


# CUgraphNodeType (cuda.h)
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                    "wait_event", "event_record", "ext_semas_signal",
                    "ext_semas_wait", "mem_alloc", "mem_free",
                    "batch_mem_op", "conditional")


def graph_node_types(fn) -> list[str]:
    """The type of every node of a CUDA graph captured around one fn()
    call, read back through the driver API: each device op fn issues
    (a kernel, a memset, a copy) is one node.  Unlike a profiler trace,
    capture records every op or fails."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    types = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
              "cuGraphNodeGetType")
        types.append(GRAPH_NODE_TYPES[t.value]
                     if 0 <= t.value < len(GRAPH_NODE_TYPES) else str(t.value))
    g.reset()
    return types


def time_best(fn, passes: int = 3) -> float:
    """Best host-clock seconds of fn() over passes, each ending in
    torch.cuda.synchronize()."""
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def stage_ms(entry, batches, lengths, bfinal) -> dict[str, float]:
    """ms per pass over ``batches`` of each stage of a compress entry,
    from CUDA events recorded at its ``on_stage`` marks."""
    out: dict[str, float] = {}
    for b in batches:
        marks = []

        def on_stage(name, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        entry(b, lengths, bfinal, on_stage=on_stage)
        torch.cuda.synchronize()
        for (name, ev), (_, nxt) in zip(marks, marks[1:]):
            out[name] = out.get(name, 0.0) + ev.elapsed_time(nxt)
    return out


def greedy_pack_inputs(tier: str, bufs, lengths):
    """The pack kernel's (sbuf, gw, nwords) for one batch of a greedy
    tier, built by the stage functions its entry calls."""
    from libdeflate_tpu_torch.compress import bits
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import pipeline as pp
    if tier == "static":
        bp, pos, cm, cl, eff, dist = pp.parse_chunk(bufs, lengths)
        val, nb = pp.static_items(bp, cm, cl, eff, dist)
        offs = pp.exclusive_bit_offsets(nb)[0] + 3
        return (*pp.group_premerge(val, nb, offs, capw=bits.GROUP_CAPW),
                pp.static_nwords(bufs.shape[1]))
    options, refine = pd.greedy_options(**pd.TIERS[tier])
    bp, pos, cm, cl, eff, dist = pp.parse_chunk(bufs, lengths, **options)
    (val, nb, offs), _ = pd.emit_dynamic_pre(bp, cm, cl, eff, dist, refine)
    return (*pp.group_premerge(val, nb, offs, capw=pd.DYN_CAPW_DEEP
                               if refine else pd.DYN_CAPW),
            pd.dyn_nwords(bufs.shape[1]))


def feasible_rungs(ladder, S: int) -> int:
    """Rungs f of ``ladder`` with t + f <= S, summed over t in one
    S-position segment."""
    return sum(sum(1 for f in ladder if t + f <= S) for t in range(S))


class StageClock:
    """Host seconds spent inside wrapped functions, each call bracketed by
    torch.cuda.synchronize(), summed by name."""

    def __init__(self):
        self.s: dict[str, float] = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed


def option_entries() -> dict:
    """The options phase's configurations: name -> (entry, K1 launches a
    call, the pin it is held to in ``experiments/option_total_bits.json``).
    ``scripts/tier_matrix.py``'s names through
    ``experiments/tier_matrix.py``'s table; ``scripts/ratio_ab.py``'s
    rowlit+lcp12 and the deep tier with round probes through
    ``compress_chunks_optimal_with``; ``scripts/exp_r5_speed.py``'s
    dyn-lcp8-d4; the lean tier, and its keywords with ``pm_group=64``
    (held to lean's pin) and with ``emit_blocks=4``, and leanD's with
    ``emit_blocks=4``."""
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.experiments import tier_matrix as tm
    named = tm.tier_configs()
    out = {name: (named[name], tm.CONFIGS[name]["passes"], name)
           for name in ("leanD(C+dense)", "leanI(D+flatlit1)",
                        "lean1XR(p1,rawC,rowlit)", "lean1X8(p1,rawC,lcp8)",
                        "lean1XR8(rawC,rowlit,lcp8)")}
    p1 = tm.CONFIGS["lean1X(p1,rawC)"]
    lean = dict(p1, strides2=(), refine=0, lit_sample=32)
    with_ = po.compress_chunks_optimal_pallas_with
    out.update({
        "rowlit+lcp12": (functools.partial(po.compress_chunks_optimal_with,
                                           **p1, row_lit1=True, lcp=12),
                         1, "rowlit+lcp12"),
        "deep+round_probes": (functools.partial(
            po.compress_chunks_optimal_with, depth=12, two_pass=True,
            hash3=True, passes=3, content_doublings=2,
            ladder=pk.LEN_LADDER_DENSE2, match_bias16=po.SHORT_BIAS16,
            content_round_probes=True), 3, "deep+round_probes"),
        "dyn-lcp8-d4": (functools.partial(pd.compress_chunks_dynamic_with,
                                          lcp=8, depth=4), 0, "dyn-lcp8-d4"),
        "lean": (po.compress_chunks_lean, 1, "lean"),
        "lean+pm_group64": (functools.partial(with_, **lean, pm_group=64), 1,
                            "lean"),
        "lean+emit_blocks4": (functools.partial(with_, **lean, emit_blocks=4),
                              1, "lean+emit_blocks4"),
        "leanD+emit_blocks4": (functools.partial(
            with_, **tm.CONFIGS["leanD(C+dense)"], emit_blocks=4), 2,
            "leanD+emit_blocks4")})
    return out


def options_phase(root: Path, corpus: bytes, chunks: np.ndarray, batches,
                  lengths, card: str) -> dict:
    """The compress options only ``scripts/`` reaches, at full width: each
    configuration of ``option_entries`` over the corpus in 1 MiB chunks,
    B = 4 a call, the chunks not final (as ``scripts/tier_matrix.py``
    calls them), the launch counts set to 0 before each configuration and
    read after it; every chunk's total_bits equal to its pin, every chunk
    inflating through zlib, lean+pm_group64's words equal to lean's; the
    pass time (host clock, best of 3 after the checked pass) and ratio a
    configuration.  K1 at LEN_LADDER_DENSE held to its plain version on
    leanD's two passes and leanI's first, and timed (CUDA events, mean of
    20) beside the 80- and 28-rung ladders on leanD's pass-1 inputs and
    beside each ladder's bounds; K2 at capw + 1 = 59, 62 and 24 (lean and
    leanD with four blocks, lean with 64-item groups) held to its plain
    version and timed by graph replay beside index_add_.  Returns the
    launches, the largest errors and the times for the kernel line."""
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import pipeline as pp
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.experiments.harness import record_calls
    from libdeflate_tpu_torch.experiments.timing import cuda_ms, graph_ms
    t_phase = time.perf_counter()
    dev = lengths.device
    pinned = json.loads((root / OPTION_BITS).read_text())["total_bits"]
    nchunks = len(chunks)
    bfinal = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    entries = option_entries()
    launches, words = {}, {}
    chain = {}
    for name, (entry, dp_calls, pin) in entries.items():
        for mod in (pk, sk, dd, ck, qk):
            mod.reset_launch_counts()
        outs = [entry(b, lengths, bfinal) for b in batches]
        torch.cuda.synchronize()
        got = {"dp_parse": pk.dp_parse.launches,
               "pack_groups": pk.pack_groups.launches,
               "commit_fsm": sk.commit_fsm.launches,
               "code_lens": sk.code_lens.launches}
        # C3 once a DP call; C4 once a greedy call (and once more where a
        # rescue pass runs)
        chain[name] = chain_counts(ck)
        nb = len(batches)
        if chain[name]["chain_relax"] != (nb if dp_calls else 0) \
                or chain[name]["chain_double"] not in (
                    (0, nb) if dp_calls else (nb, 2 * nb)):
            raise AssertionError(f"options, {name}: C3/C4 launches "
                                 f"{chain[name]}")
        # C5 once a call: the lean candidates, the greedy pass or (deep
        # with round probes) the rescue pass
        if qk.segment_probe.launches != nb:
            raise AssertionError(f"options, {name}: C5 launches "
                                 f"{qk.segment_probe.launches}, not {nb}")
        chain[name].update(probe_counts())
        # a commit and a code-length build a cost pass (the last build is
        # the emission's), one each for the greedy configuration
        want = {"dp_parse": dp_calls * len(batches),
                "pack_groups": len(batches),
                "commit_fsm": max(dp_calls, 1) * len(batches),
                "code_lens": max(dp_calls, 1) * len(batches)}
        if got != want or dd.decompress_chunks_words.launches:
            raise AssertionError(f"options, {name}: launches {got}, not "
                                 f"{want}")
        launches[name] = got
        w_all = torch.cat([w for w, _ in outs])
        if pin == "lean":
            words[name] = w_all
        bits = torch.cat([t for _, t in outs])
        if bits.tolist() != pinned[pin]:
            raise AssertionError(f"options, {name}: total_bits "
                                 f"{bits.tolist()} differ from the JAX "
                                 f"package's {pinned[pin]}")
        w_cpu = w_all.cpu()
        for k in range(nchunks):
            stream = pp.device_stream_to_bytes(w_cpu[k], bits[k])
            # no BFINAL: the stream ends in a sync flush, not a final block
            if zlib.decompressobj(-15).decompress(stream) != \
                    chunks[k].tobytes():
                raise AssertionError(f"options, {name}: chunk {k} does not "
                                     f"inflate to its input")
        best = time_best(lambda: [entry(b, lengths, bfinal)
                                  for b in batches])
        ratio = int(((bits + 7) // 8).sum()) / len(corpus)
        print(f"options, {name}: {len(corpus) / best / 1e9:.6f} GB/s (best "
              f"of 3 passes over {len(corpus)} bytes after the checked one, "
              f"{best:.6f} s), ratio {ratio:.6f}; all {nchunks} total_bits "
              f"equal the JAX package's ({pin}), every chunk inflates "
              f"through zlib; launches {json.dumps(got)} for {len(batches)} "
              f"calls; {card}", flush=True)
    if not torch.equal(words["lean+pm_group64"], words["lean"]):
        raise AssertionError("options: lean with pm_group=64 gives other "
                             "words than lean")
    total = {k: sum(n[k] for n in launches.values())
             for k in ("dp_parse", "pack_groups", "commit_fsm", "code_lens")}
    total.update({k: sum(n[k] for n in chain.values())
                  for k in ("chain_relax", "chain_double")})
    print(f"options launches: {json.dumps(total)}; lean+pm_group64's words "
          f"equal lean's", flush=True)

    # K1 at LEN_LADDER_DENSE on leanD's and leanI's own inputs
    err_dp = 0
    dps = {}
    for name in ("leanD(C+dense)", "leanI(D+flatlit1)"):
        _, calls = record_calls(pk, "dp_parse", lambda: entries[name][0](
            batches[0], lengths, bfinal))
        dps[name] = calls
        for i, args in enumerate(calls[:2 if name.startswith("leanD") else 1]):
            if args[14] != pk.LEN_LADDER_DENSE:
                raise AssertionError(f"{name}: the DP ran at another ladder")
            err_dp = max(err_dp, require_equal(
                f"dp_parse ({name}, pass {i + 1}, 46 rungs)",
                pk.dp_parse(*args), pk.dp_parse_plain(*args)))
    a = dps["leanD(C+dense)"][0][:14]
    lanes = BATCH * CHUNK // po.DP_SEG
    span = torch.empty(BATCH, CHUNK, dtype=torch.int64, device=dev)
    dist = torch.empty_like(span)
    dp_bytes = (sum(x.numel() * x.element_size() for x in a[:13])
                + 2 * 8 * BATCH * CHUNK)
    ladders = {}
    for ladder in (pk.LEN_LADDER_DENSE, pk.LEN_LADDER_DENSE2, pk.LEN_LADDER):
        ops = feasible_rungs(ladder, po.DP_SEG) * lanes * DP_OPS_PER_RUNG
        row = {"inputs": "leanD(C+dense), pass 1, text batch",
               "ms": cuda_ms(lambda: pk.dp_parse(*a, ladder), 20),
               "kernel_ms": cuda_ms(lambda: pk.dp_parse_into(
                   a[:12], a[12], po.DP_SEG, span, dist, ladder), 20),
               "bytes_bound_ms": 1e3 * dp_bytes / H100_BYTES_PER_S,
               "ops_bound_ms": 1e3 * ops / H100_INT32_OPS_PER_S}
        if ladder == pk.LEN_LADDER_DENSE:
            row["plain_ms"] = cuda_ms(lambda: pk.dp_parse_plain(*a, ladder),
                                      1)
        ladders[f"{len(ladder)} rungs"] = row
        print(f"K1 ({len(ladder)} rungs, leanD's inputs): {json.dumps(row)}; "
              f"{card}", flush=True)
    print("K1 dp_parse: equal to its plain version at LEN_LADDER_DENSE on "
          "leanD's two passes and leanI's first (text batch)", flush=True)

    # K2 at the new widths, on each configuration's own inputs
    err_pack = 0
    widths = {}
    for name in ("lean+emit_blocks4", "leanD+emit_blocks4",
                 "lean+pm_group64"):
        _, calls = record_calls(pk, "pack_groups", lambda: entries[name][0](
            batches[0], lengths, bfinal))
        sb, g, nw = calls[0]
        err_pack = max(err_pack, require_equal(
            f"pack_groups ({name})", [pk.pack_groups(sb, g, nw)],
            [pk.group_place(sb, g, nw)]))
        row = {"sbuf": list(sb.shape), "nwords": nw,
               "launches": launches[name]["pack_groups"],
               "ms": graph_ms(lambda: pk.pack_groups(sb, g, nw), 200),
               "library_ms": graph_ms(index_add_call(sb, g, nw), 200),
               "bound_ms": 1e3 * 8 * (sb.numel() + g.numel() + BATCH * nw)
               / H100_BYTES_PER_S}
        widths[f"{sb.shape[2]} ({name})"] = row
        print(f"K2 ({name}, capw + 1 = {sb.shape[2]}, graph replay): equal "
              f"to the plain version; {json.dumps(row)}; {card}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"options phase: {seconds:.3f} s", flush=True)
    return {"launches": total, "per_config": launches, "chain": chain,
            "err_dp": err_dp,
            "err_pack": err_pack, "ladders": ladders, "widths": widths,
            "seconds": seconds}


def whole_file_phase(root: Path, corpus: bytes, chunks: np.ndarray,
                     zbufs: np.ndarray, z_clen: np.ndarray, chunk_pins: dict,
                     card: str) -> dict:
    """The whole-file codec on the card through its entry points
    (``gzip/zlib/deflate_compress_dp`` over ``make_chunk_mesh()``, then
    ``compress_chunks_dp`` and ``decompress_chunks_dp``); each K1 and K2
    launch of a level's checked call is held to its plain version on the
    same inputs.  Returns the kernels' launches a call and their largest
    differences from the plain versions."""
    from libdeflate_tpu_torch import entry as pe
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments.harness import Recording
    from libdeflate_tpu_torch.formats import gzip_fmt, zlib_fmt
    from libdeflate_tpu_torch.parallel import file_codec as fc
    from libdeflate_tpu_torch.parallel import mesh as pm

    mesh = pm.make_chunk_mesh()
    ndev = len(mesh.devices)
    pins = json.loads((root / FILE_PINS).read_text())["gzip"]
    nchunks = len(chunks)
    stored_size = 5 * -(-CHUNK // 65535) + CHUNK + 5
    originals = {name: getattr(pm, name) for name in (
        "chunk_compressor", "crc32_chunks", "adler32_chunks",
        "compress_shards")}
    file_launches = {}
    errs = {"dp_parse": 0, "pack_groups": 0}
    for level, (pin_name, dp_calls, timed_calls) in FILE_LEVELS.items():
        clock = StageClock()
        gathered = []
        recs = {name: Recording(getattr(pk, name)) for name in errs}

        def compress_dp(*args, **kwargs):
            out = originals["compress_shards"](*args, **kwargs)
            gathered.append(torch.cat([s[1].cpu() for s in out]).tolist())
            return out

        pm.chunk_compressor = lambda lv: clock.wrap(
            "tier", originals["chunk_compressor"](lv))
        pm.crc32_chunks = clock.wrap("checksums", originals["crc32_chunks"])
        pm.adler32_chunks = clock.wrap("checksums",
                                       originals["adler32_chunks"])
        pm.compress_shards = compress_dp
        for name, rec in recs.items():
            setattr(pk, name, rec)
        try:
            for mod in (pk, sk, dd, ck, qk):
                mod.reset_launch_counts()
            out = fc.gzip_compress_dp(corpus, mesh, CHUNK, level)
            torch.cuda.synchronize()
            launches = {"pack_groups": pk.pack_groups.launches,
                        "dp_parse": pk.dp_parse.launches,
                        "commit_fsm": sk.commit_fsm.launches,
                        "code_lens": sk.code_lens.launches,
                        "decode_chunks": dd.decompress_chunks_words.launches,
                        **chain_counts(ck), **probe_counts()}
        finally:
            for name, rec in recs.items():
                setattr(pk, name, rec.wrapper)
        try:
            # each launch of the checked call against its plain version on
            # the same inputs: K1 at its own ladder, K2 against group_place
            shapes = []
            for i, (args, res) in enumerate(zip(recs["dp_parse"].seen,
                                                recs["dp_parse"].results)):
                errs["dp_parse"] = max(errs["dp_parse"], require_equal(
                    f"dp_parse (whole file, level {level}, launch {i + 1})",
                    list(res), pk.dp_parse_plain(*args)))
                shapes.append(f"K1 launch {i + 1}: inputs "
                              f"{list(args[0].shape)}, lc "
                              f"{list(args[12].shape)}, S {args[13]}, "
                              f"{len(args[14])} rungs")
            for args, res in zip(recs["pack_groups"].seen,
                                 recs["pack_groups"].results):
                errs["pack_groups"] = max(errs["pack_groups"], require_equal(
                    f"pack_groups (whole file, level {level})", [res],
                    [pk.group_place(*args)]))
                shapes.append(f"K2: sbuf {list(args[0].shape)}, words "
                              f"{list(res.shape)}")
            del recs
            # the checked call was the warm-up; time the next ones
            clock.s.clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for _ in range(timed_calls):
                t0 = time.perf_counter()
                fc.gzip_compress_dp(corpus, mesh, CHUNK, level)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
        finally:
            for name, fn in originals.items():
                setattr(pm, name, fn)
        passes = max(dp_calls, 1)
        want = {"pack_groups": ndev, "dp_parse": dp_calls * ndev,
                "commit_fsm": passes * ndev,
                "code_lens": 0 if pin_name == "static" else passes * ndev,
                "decode_chunks": 0,
                **{n: c * ndev for n, c in FILE_CHAIN[level].items()},
                "segment_probe": FILE_PROBE[level] * ndev}
        if launches != want:
            raise AssertionError(f"whole file, level {level}: launches "
                                 f"{launches}, not {want}")
        file_launches[level] = launches
        if zlib.decompress(out, 31) != corpus:
            raise AssertionError(f"whole file, level {level}: the gzip stream "
                                 f"does not inflate to the corpus")
        if gzip_fmt.parse_header(out) != gzip_fmt.MIN_HEADER_SIZE:
            raise AssertionError("whole file: the gzip header does not parse")
        if gathered[0] != chunk_pins[pin_name]:
            raise AssertionError(f"whole file, level {level}: all_bits "
                                 f"{gathered[0]} differ from the JAX "
                                 f"package's {chunk_pins[pin_name]}")
        digest = hashlib.sha256(out).hexdigest()
        pin = pins[str(level)]
        if (len(out), digest) != (pin["bytes"], pin["sha256"]):
            raise AssertionError(f"whole file, level {level}: {len(out)} "
                                 f"bytes, SHA-256 {digest}; the JAX package "
                                 f"gives {pin['bytes']}, {pin['sha256']}")
        stored = [i for i, b in enumerate(gathered[0])
                  if b // 8 > stored_size]
        best = min(secs)
        tier_s = clock.s.get("tier", 0.0) / timed_calls
        sums_s = clock.s.get("checksums", 0.0) / timed_calls
        mean = sum(secs) / timed_calls
        print(f"whole file, gzip level {level}: {len(corpus) / best / 1e9:.6f}"
              f" GB/s ({'best of 3 calls' if timed_calls == 3 else 'one call'}"
              f" after a warm-up, {best:.6f} s for {len(corpus)} bytes in "
              f"{nchunks} chunks of {CHUNK} on {ndev} device(s)), ratio "
              f"{len(out) / len(corpus):.6f}; {len(out)} bytes with the JAX "
              f"package's SHA-256, all_bits equal to its {pin_name} "
              f"total_bits, inflates through zlib; stored fallback chunks "
              f"{stored}; launches {json.dumps(launches)}; a call's mean "
              f"{mean:.6f} s: tier entries {tier_s:.6f} s, checksums "
              f"{sums_s:.6f} s, off the tier entries "
              f"{1 - tier_s / mean:.6f} of it; peak memory {peak} bytes "
              f"(torch.cuda.max_memory_allocated over the timed calls), "
              f"{peak - base} above the {base} held before them; {card}",
              flush=True)
        print(f"whole file, gzip level {level}: every K1 and K2 launch of "
              f"the checked call equals its plain version (dp_parse_plain, "
              f"group_place) on the same inputs: {'; '.join(shapes)}",
              flush=True)

    # zlib and raw DEFLATE at level 1: round trip, CRC-32 and Adler-32
    zout = fc.zlib_compress_dp(corpus, mesh, CHUNK, 1)
    stream, crc, adler = fc.deflate_compress_dp(corpus, mesh, CHUNK, 1)
    if (zlib.decompress(zout) != corpus
            or zlib_fmt.parse_header(zout) != zlib_fmt.MIN_HEADER_SIZE
            or zlib.decompress(stream, -15) != corpus
            or (crc, adler) != (zlib.crc32(corpus), zlib.adler32(corpus))):
        raise AssertionError("whole file: zlib_compress_dp or "
                             "deflate_compress_dp at level 1 is wrong")
    print(f"whole file, zlib and raw DEFLATE at level 1: both inflate to the "
          f"corpus; crc32 {crc:#010x} and adler32 {adler:#010x} equal zlib's",
          flush=True)

    # the decode direction: level-6 fragments with BFINAL on every chunk,
    # and zlib-6 streams of the same chunks, through decompress_chunks_dp
    dev = mesh.devices[0]
    lengths = np.full(nchunks, CHUNK, np.int32)
    words, total_bits, _, _, _ = pm.compress_chunks_dp(
        mesh, chunks, lengths, np.ones(nchunks, bool), level=6)
    if total_bits.tolist() != chunk_pins["level5"]:
        raise AssertionError("compress_chunks_dp, level 6: total_bits differ "
                             "from the JAX package's")
    frag_bufs = words.view(torch.uint8)
    frag_lens = ((total_bits + 7) // 8).to(torch.int32)
    corpus_d = torch.as_tensor(chunks.copy(), device=dev)
    sets = {"level 6 fragments": (frag_bufs, frag_lens),
            "zlib-6": (zbufs, z_clen)}
    dec_s = {}
    for name, (cb, cl) in sets.items():
        dd.reset_launch_counts()
        pk.reset_launch_counts()
        fsm.reset_launch_counts()
        out, olen, consumed, status, all_lens = pm.decompress_chunks_dp(
            mesh, cb, cl, lengths, CHUNK)
        torch.cuda.synchronize()
        # "auto" on the card is K3: one launch a shard, F1 never
        if (dd.decompress_chunks_words.launches != ndev
                or fsm.decompress_chunks.launches
                or pk.pack_groups.launches or pk.dp_parse.launches):
            raise AssertionError(f"decompress_chunks_dp ({name}): launches "
                                 f"{dd.decompress_chunks_words.launches}, "
                                 f"F1 {fsm.decompress_chunks.launches}")
        if not (bool((status == 0).all()) and bool((olen == CHUNK).all())
                and torch.equal(all_lens, olen)
                and torch.equal(consumed.cpu(), torch.as_tensor(cl).cpu())
                and torch.equal(out, corpus_d)):
            raise AssertionError(f"decompress_chunks_dp ({name}): a chunk "
                                 f"does not decode to the corpus")
        dec_s[name] = time_best(lambda: pm.decompress_chunks_dp(
            mesh, cb, cl, lengths, CHUNK))
    # one corrupt chunk is isolated; out_lens one short is BAD_DATA
    bad = frag_bufs.clone()
    bad[3, :8] = 0xFF
    status = pm.decompress_chunks_dp(mesh, bad, frag_lens, lengths,
                                     CHUNK)[3].tolist()
    if status[3] == 0 or status[:3] + status[4:] != [0] * (nchunks - 1):
        raise AssertionError(f"decompress_chunks_dp: corrupt chunk 3 gives "
                             f"statuses {status}")
    wrong = lengths.copy()
    wrong[1] -= 1
    status = pm.decompress_chunks_dp(mesh, frag_bufs, frag_lens, wrong,
                                     CHUNK)[3].tolist()
    if status != [0, 1] + [0] * (nchunks - 2):
        raise AssertionError(f"decompress_chunks_dp: out_lens one short "
                             f"gives statuses {status}")
    for name, best in dec_s.items():
        print(f"whole file, decompress_chunks_dp ({name}): "
              f"{len(corpus) / best / 1e9:.6f} GB/s of output (best of 3 "
              f"calls, {best:.6f} s for {nchunks} x {CHUNK} bytes), every "
              f"chunk equals the corpus, one decode_chunks launch a shard "
              f"and no fsm_decode launch (decoder \"auto\"); {card}",
              flush=True)
    # decoder="fsm": the FSM decoder (F1) on each shard
    dd.reset_launch_counts()
    fsm.reset_launch_counts()
    out, olen, consumed, status, all_lens = pm.decompress_chunks_dp(
        mesh, frag_bufs, frag_lens, lengths, CHUNK, decoder="fsm")
    torch.cuda.synchronize()
    fsm_launches = fsm.decompress_chunks.launches
    if fsm_launches != ndev or dd.decompress_chunks_words.launches:
        raise AssertionError(f"decompress_chunks_dp (fsm): F1 launches "
                             f"{fsm_launches}, K3 "
                             f"{dd.decompress_chunks_words.launches}")
    if not (bool((status == 0).all()) and bool((olen == CHUNK).all())
            and torch.equal(all_lens, olen)
            and torch.equal(consumed, frag_lens)
            and torch.equal(out, corpus_d)):
        raise AssertionError("decompress_chunks_dp (fsm): a chunk does not "
                             "decode to the corpus")
    best = time_best(lambda: pm.decompress_chunks_dp(
        mesh, frag_bufs, frag_lens, lengths, CHUNK, decoder="fsm"))
    print(f"whole file, decompress_chunks_dp (level 6 fragments, decoder "
          f"\"fsm\"): {len(corpus) / best / 1e9:.6f} GB/s of output (best "
          f"of 3 calls, {best:.6f} s), every chunk equals the corpus, one "
          f"fsm_decode launch a shard and no decode_chunks launch; {card}",
          flush=True)
    print("whole file, decompress_chunks_dp: a corrupt chunk 3 fails alone; "
          "out_lens one short on chunk 1 is BAD_DATA", flush=True)

    # the entry module on the card
    fn, args = pe.entry()
    fn_cpu, args_cpu = pe.entry(device="cpu")
    require_equal("entry(): CUDA vs CPU", [x.cpu() for x in fn(*args)],
                  fn_cpu(*args_cpu))
    pe.dryrun_multichip(1)
    print("entry(): dyn1 on the card equals the CPU; dryrun_multichip(1) "
          "passes", flush=True)
    return {"compress": file_launches, "decode_chunks": ndev,
            "fsm_decode": fsm_launches, "max_abs_err": errs}


MESH_SHARDS = (2, 4)        # shards at once on ["cuda:0"] * k
MESH_TIMED_LEVELS = (1, 6)  # whole-file levels timed at k = 1, 2 and 4
# each wrapper's kernel, as its name stands in a profiler trace
SIDE_KERNELS = {"dp_parse": "dp_parse_kernel",
                "pack_groups": "pack_gather_kernel",
                "decode_chunks": "decode_chunks_kernel",
                "tokenize_chunks": "tokenize_chunks_kernel",
                "fsm_decode": "fsm_decode_kernel",
                "commit_fsm": "commit_fsm_kernel",
                "code_lens": "code_lens_kernel",
                "grid_add_one": "add_one_grid_kernel",
                "loop_add_one": "add_one_loop_kernel",
                "grid_copy": "grid_copy_kernel",
                "chain_relax": "chain_relax_kernel",
                "chain_double": "chain_double_kernel",
                "segment_probe": "segment_probe_kernel"}


def side_stream_calls(root: Path, dev) -> dict:
    """{kernel name: (a call of its wrapper on small CUDA inputs, the
    plain version's result on the same inputs)} for every wrapper."""
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments import crafted_chain as cc
    from libdeflate_tpu_torch.experiments import crafted_dp as cdp
    from libdeflate_tpu_torch.experiments import crafted_probe as cq
    from libdeflate_tpu_torch.experiments import crafted_streams as cs
    from libdeflate_tpu_torch.experiments import exp_device_roundup as rd
    from libdeflate_tpu_torch.experiments import exp_launch_overhead as lo
    from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk

    def cpu(args):
        return [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]

    rng = np.random.default_rng(11)
    dp = cdp.random_inputs(dev, B=2, n_pad=512)
    pack = pack_random_inputs(dev, B=2, m=64)
    text = cs.repo_text(root)
    raws = [text[i * 8192:(i + 1) * 8192] for i in range(4)]
    comp, clen = dd.pack_streams([zlib6(r) for r in raws])
    olen = np.array(list(map(len, raws)), np.int32)
    rows = comp.view(np.uint8)
    commit = (torch.as_tensor(rng.integers(1, 40, (2, 2048)), device=dev),
              torch.as_tensor(rng.random((2, 2048)) < 0.6, device=dev),
              torch.as_tensor(rng.integers(0, 5, (2, 2048)), device=dev), 512)
    hist = torch.as_tensor(rng.integers(0, 300, (4, 286)), device=dev)
    x_grid = torch.as_tensor(rng.integers(0, 1 << 20, (64, 128)),
                             dtype=torch.int32, device=dev)
    x_copy = torch.as_tensor(rng.random((128, 128)), dtype=torch.float32,
                             device=dev)
    relax = [tuple(torch.as_tensor(x, device=dev) for x in c)
             for c in cc.relax_sets(3)["random"]]
    double = [torch.as_tensor(x, device=dev)
              for c in cc.double_sets(2)["random"] for x in c]
    h, bp, seg, _ = cq.probe_sets()["short, n_pad 5120"]
    probe = (torch.as_tensor(h, device=dev), torch.as_tensor(bp, device=dev),
             seg, 6, 16, "lean")
    return {
        "dp_parse": (lambda: pk.dp_parse(*dp, 256),
                     pk.dp_parse_plain(*cpu(dp), 256)),
        "pack_groups": (lambda: [pk.pack_groups(*pack)],
                        [pk.group_place(*cpu(pack))]),
        "decode_chunks": (
            lambda: dd.decompress_chunks_words(comp.view(np.int32), clen,
                                               olen, 8192),
            dd.decompress_chunks_words(comp.view(np.int32), clen, olen, 8192,
                                       device="cpu")),
        "tokenize_chunks": (
            lambda: tk.tokenize_chunks(comp.view(np.int32), clen, olen),
            tk.tokenize_chunks(comp.view(np.int32), clen, olen,
                               device="cpu")),
        "fsm_decode": (lambda: fsm.decompress_chunks(rows, clen, 8192),
                       fsm.decompress_chunks(rows, clen, 8192, device="cpu")),
        "commit_fsm": (lambda: sk.commit_fsm(*commit),
                       sk.greedy_commit_merge(*cpu(commit))),
        "code_lens": (lambda: sk.code_lens(hist, 16, 15),
                      sk.build_code_lens(hist.cpu(), 16, 15)),
        "grid_add_one": (lambda: [lo.grid_add_one(x_grid)],
                         [x_grid.cpu() + 1]),
        "loop_add_one": (lambda: [lo.loop_add_one(x_grid)],
                         [x_grid.cpu() + 1]),
        "grid_copy": (lambda: [rd.grid_copy(x_copy, rd.PROBE_STEPS[-1])],
                      [x_copy.cpu()]),
        "chain_relax": (
            lambda: chain_flat("chain_extend_multi",
                               ck.chain_extend_multi(relax)),
            chain_flat("chain_extend_multi", ck.chain_extend_multi_plain(
                [tuple(x.cpu() for x in c) for c in relax]))),
        "chain_double": (lambda: list(ck.chain_extend2(*double)),
                         list(ck.chain_extend2_plain(*cpu(double)))),
        "segment_probe": (lambda: probe_flat(qk.segment_probe(*probe)),
                          probe_flat(qk.segment_probe(*cpu(probe)))),
    }


def side_stream_phase(root: Path, dev, card: str) -> dict:
    """Every kernel wrapper (K1-K7, F1, C1-C5) called from a worker
    thread whose current stream is a side stream of its own: each result
    equals the plain version, and a profiler trace shows each kernel on
    that stream, not on the stream of the calling thread's marker op.
    The wrappers' launch counts are left as they were.  Returns each
    kernel's largest difference from its plain version (0)."""
    import tempfile
    import threading

    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments import exp_device_roundup as rd
    from libdeflate_tpu_torch.experiments import exp_launch_overhead as lo
    from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk
    from libdeflate_tpu_torch.utils.profiling import device_trace

    wrappers = [pk.dp_parse, pk.pack_groups, dd.decompress_chunks_words,
                tk.tokenize_chunks, fsm.decompress_chunks, sk.commit_fsm,
                sk.code_lens, lo.grid_add_one, lo.loop_add_one, rd.grid_copy,
                ck.chain_extend_multi, ck.chain_extend, ck.chain_extend2,
                qk.segment_probe]
    counts = [w.launches for w in wrappers]
    calls = side_stream_calls(root, dev)
    for name, (fn, _) in calls.items():      # built and warm on this stream
        fn()
    torch.cuda.synchronize()
    results, errors = {}, []
    side = torch.cuda.Stream(dev)

    def work():
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side):
                for name, (fn, _) in calls.items():
                    results[name] = fn()
            side.synchronize()
        except BaseException as e:              # raised after the join
            errors.append(e)

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(str(Path(tmp) / "trace")):
            marker = torch.zeros(4096, device=dev) + 1  # the caller's stream
            worker = threading.Thread(target=work, name="side-stream check")
            worker.start()
            worker.join()
            torch.cuda.synchronize()
        (trace_file,) = (Path(tmp) / "trace").glob("trace_*.json")
        events = [e for e in json.loads(trace_file.read_text())
                  ["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") == "kernel"]
    del marker
    for w, n in zip(wrappers, counts):
        w.launches = n
    if errors:
        raise errors[0]
    err = {name: require_equal(f"{name} (worker thread, side stream)",
                               [r.cpu() for r in results[name]],
                               list(want))
           for name, (_, want) in calls.items()}
    streams = {name: sorted({e["args"]["stream"] for e in events
                             if kern in e["name"]})
               for name, kern in SIDE_KERNELS.items()}
    caller = sorted({e["args"]["stream"] for e in events
                     if not any(k in e["name"]
                                for k in SIDE_KERNELS.values())
                     and e["ts"] < min(
                         [float(x["ts"]) for x in events
                          if any(k in x["name"]
                                 for k in SIDE_KERNELS.values())] or [0])})
    ids = {s for v in streams.values() for s in v}
    if any(len(v) != 1 for v in streams.values()) or len(ids) != 1 \
            or ids & set(caller):
        raise AssertionError(f"side streams: each wrapper's kernel should "
                             f"run on the worker's one side stream, not on "
                             f"the caller's {caller}: {streams}")
    print(f"side streams: every wrapper called from a worker thread on a "
          f"side stream equals its plain version, and the trace shows each "
          f"kernel on that stream (id {ids.pop()}), not the caller's "
          f"(ids {caller}): {', '.join(calls)}; {card}", flush=True)
    return err


def mesh_phase(root: Path, corpus: bytes, chunks: np.ndarray,
               zbufs: np.ndarray, z_clen: np.ndarray, chunk_pins: dict,
               card: str) -> dict:
    """The chunk mesh with its shards at once on one card,
    ``make_chunk_mesh(["cuda:0"] * k)``: gzip at every pinned level for
    k = 2 and 4 (the bytes equal to the pins, k times a shard's launches,
    each pass's K1 launches of all shards as one batch and every K2 launch
    held to the plain versions); ``decompress_chunks_dp`` at k = 4 with
    decoders "pallas" and "fsm"; the whole-file times at k = 1, 2 and 4
    (levels 1 and 6) and a trace of one level-6 call at k = 4 (idle
    share, streams, ms with two or more streams running); every wrapper
    on a side stream from a worker thread (``side_stream_phase``); and,
    with more than one card, ``dryrun_multichip`` over every card, the
    level-6 pin over every card and the level-6 tier on cuda:1 alone.
    Returns the launches, the largest differences and the times."""
    import tempfile

    from libdeflate_tpu_torch import entry as pe
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments.harness import Recording
    from libdeflate_tpu_torch.experiments.pass_turns import (stream_overlap,
                                                             trace_summary)
    from libdeflate_tpu_torch.parallel import file_codec as fc
    from libdeflate_tpu_torch.parallel import mesh as pm
    from libdeflate_tpu_torch.utils.profiling import device_trace

    dev = torch.device("cuda", 0)
    pins = json.loads((root / FILE_PINS).read_text())["gzip"]
    nchunks = len(chunks)
    errs = {"dp_parse": 0, "pack_groups": 0}
    launches: dict = {}

    def counts():
        return {"pack_groups": pk.pack_groups.launches,
                "dp_parse": pk.dp_parse.launches,
                "commit_fsm": sk.commit_fsm.launches,
                "code_lens": sk.code_lens.launches,
                "decode_chunks": dd.decompress_chunks_words.launches,
                "fsm_decode": fsm.decompress_chunks.launches,
                **chain_counts(ck), **probe_counts()}

    def reset():
        for mod in (pk, sk, dd, fsm, ck, qk):
            mod.reset_launch_counts()

    def pinned(name, out, level):
        digest = hashlib.sha256(out).hexdigest()
        pin = pins[str(level)]
        if (len(out), digest) != (pin["bytes"], pin["sha256"]):
            raise AssertionError(f"{name}, level {level}: {len(out)} bytes, "
                                 f"SHA-256 {digest}; the pin is "
                                 f"{pin['bytes']}, {pin['sha256']}")

    for k in MESH_SHARDS:
        mesh = pm.make_chunk_mesh(["cuda:0"] * k)
        launches[k] = {}
        for level, (pin_name, dp_calls, _) in FILE_LEVELS.items():
            recs = {name: Recording(getattr(pk, name)) for name in errs}
            for name, rec in recs.items():
                setattr(pk, name, rec)
            try:
                reset()
                out = fc.gzip_compress_dp(corpus, mesh, CHUNK, level)
                torch.cuda.synchronize()
                got = counts()
            finally:
                for name, rec in recs.items():
                    setattr(pk, name, rec.wrapper)
            passes = max(dp_calls, 1)
            want = {"pack_groups": k, "dp_parse": dp_calls * k,
                    "commit_fsm": passes * k,
                    "code_lens": 0 if pin_name == "static" else passes * k,
                    "decode_chunks": 0, "fsm_decode": 0,
                    **{n: c * k for n, c in FILE_CHAIN[level].items()},
                    "segment_probe": FILE_PROBE[level] * k}
            if got != want:
                raise AssertionError(f"mesh, {k} shards, level {level}: "
                                     f"launches {got}, not {want}")
            pinned(f"mesh, {k} shards", out, level)
            # K1: each pass's launches of all k shards as one batch (one
            # thread a shard, its passes in order) against the plain
            # version; K2: every launch against group_place
            by_shard: dict = {}
            rec = recs["dp_parse"]
            for args, res, th in zip(rec.seen, rec.results, rec.threads):
                by_shard.setdefault(th, []).append((args, res))
            if sorted(map(len, by_shard.values())) != [dp_calls] * (
                    k if dp_calls else 0):
                raise AssertionError(f"mesh, {k} shards, level {level}: K1 "
                                     f"launches by thread "
                                     f"{[len(v) for v in by_shard.values()]}")
            for p in range(dp_calls):
                calls = [v[p] for v in by_shard.values()]
                arrs = [torch.cat([a[i] for a, _ in calls]) for i in range(12)]
                lc = torch.cat([a[12] if a[12].dim() == 2 else
                                a[12].repeat(a[0].shape[0], 1)
                                for a, _ in calls])
                errs["dp_parse"] = max(errs["dp_parse"], require_equal(
                    f"dp_parse (mesh, {k} shards, level {level}, pass "
                    f"{p + 1})", [torch.cat([r[j] for _, r in calls])
                                  for j in range(2)],
                    pk.dp_parse_plain(*arrs, lc, *calls[0][0][13:])))
            for args, res in zip(recs["pack_groups"].seen,
                                 recs["pack_groups"].results):
                errs["pack_groups"] = max(errs["pack_groups"], require_equal(
                    f"pack_groups (mesh, {k} shards, level {level})", [res],
                    [pk.group_place(*args)]))
            del recs, rec, by_shard
            launches[k][level] = got
        print(f"mesh, {k} shards at once on one card: gzip at levels "
              f"{list(FILE_LEVELS)} equal the pinned length and SHA-256, "
              f"launches {json.dumps(launches[k])} (k times a shard's), "
              f"every K1 launch (each pass's {k} launches as one batch) "
              f"and K2 launch equal to its plain version; {card}",
              flush=True)

    # the decode direction at k = 4: level-6 fragments (BFINAL on every
    # chunk) through both decoders, and the zlib-6 streams through K3
    mesh = pm.make_chunk_mesh(["cuda:0"] * MESH_SHARDS[-1])
    k = len(mesh.devices)
    lengths = np.full(nchunks, CHUNK, np.int32)
    words, total_bits, _, _, _ = pm.compress_chunks_dp(
        mesh, chunks, lengths, np.ones(nchunks, bool), level=6)
    if total_bits.tolist() != chunk_pins["level5"]:
        raise AssertionError(f"compress_chunks_dp, {k} shards, level 6: "
                             f"total_bits differ from the JAX package's")
    frag_bufs = words.view(torch.uint8)
    frag_lens = ((total_bits + 7) // 8).to(torch.int32)
    corpus_d = torch.as_tensor(chunks.copy(), device=dev)
    dec_s = {}
    for name, decoder, cb, cl in (
            ("level 6 fragments", "pallas", frag_bufs, frag_lens),
            ("level 6 fragments", "fsm", frag_bufs, frag_lens),
            ("zlib-6", "pallas", zbufs, z_clen)):
        reset()
        out, olen, consumed, status, all_lens = pm.decompress_chunks_dp(
            mesh, cb, cl, lengths, CHUNK, decoder=decoder)
        torch.cuda.synchronize()
        got = counts()
        kern = "decode_chunks" if decoder == "pallas" else "fsm_decode"
        if {n: c for n, c in got.items() if c} != {kern: k}:
            raise AssertionError(f"decompress_chunks_dp ({name}, {decoder}, "
                                 f"{k} shards): launches {got}")
        if not (bool((status == 0).all()) and bool((olen == CHUNK).all())
                and torch.equal(all_lens, olen)
                and torch.equal(consumed.cpu(), torch.as_tensor(cl).cpu())
                and torch.equal(out, corpus_d)):
            raise AssertionError(f"decompress_chunks_dp ({name}, {decoder}, "
                                 f"{k} shards): a chunk does not decode to "
                                 f"the corpus")
        launches.setdefault("decode", {})[f"{name}, {decoder}"] = got[kern]
        dec_s[f"{name}, {decoder}"] = time_best(
            lambda: pm.decompress_chunks_dp(mesh, cb, cl, lengths, CHUNK,
                                            decoder=decoder))
    for name, best in dec_s.items():
        print(f"mesh, decompress_chunks_dp ({name}, {k} shards at once): "
              f"{len(corpus) / best / 1e9:.6f} GB/s of output (best of 3, "
              f"{best:.6f} s), every chunk equals the corpus, one launch a "
              f"shard; {card}", flush=True)

    # the whole-file times at k = 1, 2 and 4, and one traced call at k = 4
    times = {}
    for level in MESH_TIMED_LEVELS:
        for k in (1,) + MESH_SHARDS:
            mesh = pm.make_chunk_mesh(["cuda:0"] * k)
            for _ in range(3):          # as pass_turns.WARM_CALLS
                fc.gzip_compress_dp(corpus, mesh, CHUNK, level)
            torch.cuda.synchronize()
            times[f"level {level}, {k} shards"] = time_best(
                lambda: fc.gzip_compress_dp(corpus, mesh, CHUNK, level))
        line = ", ".join(f"{k} shard(s) at once "
                         f"{times[f'level {level}, {k} shards']:.6f} s"
                         for k in (1,) + MESH_SHARDS)
        print(f"mesh, whole file at level {level}, best of 3 calls after 3 "
              f"over {nchunks} x {CHUNK} bytes: {line}; {card}", flush=True)
    mesh = pm.make_chunk_mesh(["cuda:0"] * MESH_SHARDS[-1])
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(str(Path(tmp) / "trace")):
            fc.gzip_compress_dp(corpus, mesh, CHUNK, 6)
            torch.cuda.synchronize()
        (trace_file,) = (Path(tmp) / "trace").glob("trace_*.json")
        _, idle, window_ms, n_ops = trace_summary(trace_file)
        overlap = stream_overlap(trace_file)
    trace = {"idle": idle, "window_ms": window_ms, "device_ops": n_ops,
             **overlap}
    print(f"mesh, device_trace of one level-6 call at "
          f"{MESH_SHARDS[-1]} shards at once: {json.dumps(trace)}; {card}",
          flush=True)

    side_err = side_stream_phase(root, dev, card)

    ncards = torch.cuda.device_count()
    if ncards > 1:
        pe.dryrun_multichip(ncards)
        pinned("mesh over every card", fc.gzip_compress_dp(
            corpus, pm.make_chunk_mesh(), CHUNK, 6), 6)
        one = torch.device("cuda", 1)
        _, total_bits, _, _, _ = pm.compress_chunks_dp(
            pm.make_chunk_mesh([one]), chunks, lengths,
            np.ones(nchunks, bool), level=6)
        if total_bits.tolist() != chunk_pins["level5"]:
            raise AssertionError("level 6 on cuda:1: total_bits differ from "
                                 "the JAX package's")
        print(f"mesh over {ncards} cards: dryrun_multichip({ncards}) passes, "
              f"gzip level 6 over every card equals its pin, and the level-6 "
              f"tier on cuda:1 alone gives the pinned total_bits", flush=True)
    else:
        print("mesh over several cards: not run, since this machine has one "
              "CUDA device; dryrun_multichip over every card, the level-6 "
              "pin over every card and the tier on cuda:1 need two or more",
              flush=True)
    return {"launches": launches, "max_abs_err": errs, "side_err": side_err,
            "times": times, "trace": trace}


def fsm_phase(root: Path, corpus: bytes, chunks: np.ndarray,
              zbufs: np.ndarray, z_clen: np.ndarray, lean_bufs, lean_lens,
              k3_rate: dict, batch0, lengths, bfinal, card: str,
              against: Path | None = None) -> dict:
    """The FSM decoder (F1) on the card: held to its plain version on every
    set of ``experiments/fsm_cases.py`` and to the JAX package's pins
    (``experiments/fsm_pins.json``), on K3's crafted sets as byte rows
    (out_cap 81920), on batches repacked into rows of an odd length (row
    starts off alignment, an odd out_cap) and on the 16 zlib-6 chunks; its
    main path (the 16 zlib-6 and 16 lean streams of the corpus through
    ``fsm.decompress_chunks``, one B = 16 call each); with ``against``, an
    earlier ``fsm_decode.cu`` timed beside the as-built kernel in turns;
    then the programs on the corpus through their ``main`` (``gzip_cli
    --tpu -6``, ``benchmark -C ours-tpu -D ours-tpu`` and ``-D
    ours-pallas``, ``checksum -T``), and a ``device_trace`` of one
    ``compress_chunks_lean`` call.  Returns F1's launches, its largest
    difference from the plain version and its times."""
    import contextlib
    import io
    import tempfile

    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments import crafted_streams as cs
    from libdeflate_tpu_torch.experiments import fsm_cases
    from libdeflate_tpu_torch.experiments import fsm_variants as fv
    from libdeflate_tpu_torch.experiments.pass_turns import trace_summary
    from libdeflate_tpu_torch.experiments.timing import cuda_ms
    from libdeflate_tpu_torch.programs import benchmark as pbench
    from libdeflate_tpu_torch.programs import checksum as pck
    from libdeflate_tpu_torch.programs import gzip_cli as pgz
    from libdeflate_tpu_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    nchunks = len(chunks)
    dev = torch.device("cuda", 0)
    corpus_d = torch.as_tensor(chunks.copy(), device=dev)

    # ---- F1 against its plain version and the JAX package's 4-tuples ---
    pins = json.loads((root / FSM_PINS).read_text())
    err = 0
    for name, cases in fsm_cases.sets(cs.repo_text(root)).items():
        rows, n_bad = [], 0
        for bufs, lens, n in fsm_cases.batches(cases):
            got = [g.cpu() for g in fsm.decompress_chunks(bufs, lens,
                                                          fsm_cases.OUT)]
            want = fsm.decompress_chunks(bufs, lens, fsm_cases.OUT,
                                         device="cpu")
            err = max(err, require_equal(f"fsm_decode ({name})", got, want))
            rows += fsm_cases.pin_rows(*got, n)
            n_bad += int((got[3][:n] != 0).sum())
        pinned = name in pins["sets"]
        if pinned and rows != [r[1:] for r in pins["sets"][name]]:
            raise AssertionError(f"fsm_decode ({name}): 4-tuples differ from "
                                 f"the JAX package's pins")
        print(f"F1 fsm_decode ({name}, {len(cases)} streams, B = "
              f"{fsm_cases.B} x N = {fsm_cases.N}, out_cap "
              f"{fsm_cases.OUT}): equal to its plain version"
              f"{', every 4-tuple equal to the JAX pins' if pinned else ''}"
              f", {len(cases) - n_bad} OK and {n_bad} failed", flush=True)
    text = cs.repo_text(root)
    checks = [(f"crafted: {name}", bufs, lens, cs.DEC_OUT_BYTES)
              for name, (bufs, lens, _) in
              fsm_cases.crafted_batches(text).items()]
    for name in ("zlib", "edges"):
        bufs, lens, _ = fsm_cases.batches(fsm_cases.sets(text)[name])[0]
        checks.append((f"{name}, rows of {fsm_cases.ODD_N} bytes",
                       fsm_cases.repack(bufs), lens, fsm_cases.ODD_OUT))
    for name, bufs, lens, cap in checks:
        got = [g.cpu() for g in fsm.decompress_chunks(bufs, lens, cap)]
        want = fsm.decompress_chunks(bufs, lens, cap, device="cpu")
        err = max(err, require_equal(f"fsm_decode ({name})", got, want))
        n_bad = int((got[3] != 0).sum())
        print(f"F1 fsm_decode ({name}, B = {bufs.shape[0]} x N = "
              f"{bufs.shape[1]}, out_cap {cap}): equal to its plain version, "
              f"{bufs.shape[0] - n_bad} OK and {n_bad} failed", flush=True)
    z_lens = torch.as_tensor(z_clen)
    zb_d = torch.as_tensor(zbufs, device=dev)
    zl_d = z_lens.to(dev)
    got = [g.cpu() for g in fsm.decompress_chunks(zb_d, zl_d, CHUNK)]
    chain = np.zeros((2, nchunks), np.int64)
    t0 = time.perf_counter()
    want = fsm.decode_chunks_fsm_plain(torch.as_tensor(zbufs), z_lens, CHUNK,
                                       chain)
    plain_s = time.perf_counter() - t0
    err = max(err, require_equal("fsm_decode (zlib-6, 16 chunks)", got,
                                 want))
    print(f"F1 fsm_decode (zlib-6, {nchunks} x {CHUNK} bytes): equal to its "
          f"plain version, plain {plain_s:.3f} s", flush=True)

    # ---- the main path: full width through the entry point ------------
    fsm.reset_launch_counts()
    dd.reset_launch_counts()
    pk.reset_launch_counts()
    sets = {"zlib-6": (zb_d, zl_d), "lean": (lean_bufs, lean_lens)}
    for name, (b, n) in sets.items():
        out, ol, cons, res = fsm.decompress_chunks(b, n, CHUNK)
        if not (bool((res == 0).all()) and bool((ol == CHUNK).all())
                and torch.equal(cons, n) and torch.equal(out, corpus_d)):
            raise AssertionError(f"fsm decode ({name}): a chunk does not "
                                 f"decode to the corpus")
    torch.cuda.synchronize()
    launches = fsm.decompress_chunks.launches
    if launches != len(sets) or dd.decompress_chunks_words.launches \
            or pk.dp_parse.launches or pk.pack_groups.launches:
        raise AssertionError(f"fsm decode main path: F1 launches {launches}")
    rate = {}
    for name, (b, n) in sets.items():
        best = time_best(lambda: fsm.decompress_chunks(b, n, CHUNK))
        k3_gbs, k3_best = k3_rate["zlib-6" if name == "zlib-6" else
                                  "round trip"]
        rate[name] = best
        print(f"fsm decode main path ({name}, B = {nchunks}, out_cap "
              f"{CHUNK}): {len(corpus) / best / 1e9:.6f} GB/s of output "
              f"(best of 3 calls, {best:.6f} s), every chunk equals the "
              f"corpus, status 0, consumed = stream lengths; K3 on the same "
              f"streams {k3_gbs:.6f} GB/s ({k3_best:.6f} s); {card}",
              flush=True)
    print(f"fsm decode main path launches: "
          f"{json.dumps({'fsm_decode': launches})}", flush=True)
    ms = cuda_ms(lambda: fsm.decompress_chunks(zb_d, zl_d, CHUNK), 3)
    turns = None
    if against is not None:
        # the earlier kernel and a copy of this one, by their bare launches
        fns, lines = fv.build_all([fv.AS_BUILT], against)
        fns = {"parent": fns["against"], "as built": fns[fv.AS_BUILT]}
        for name, (b, n) in sets.items():
            if not fv.equal(fv.launch(fns["parent"], b, n, CHUNK),
                            fv.launch(fns["as built"], b, n, CHUNK)):
                raise AssertionError(f"F1 and its parent ({against}) differ "
                                     f"on the {name} streams")
        turns = fv.in_turns({"parent": fns["parent"],
                             "as built": fns["as built"]}, sets, CHUNK)
        print(f"F1 beside its parent ({against}; build {lines['against']}),"
              f" by CUDA events, mean of 3 calls a turn, in turns parent / "
              f"as built / as built / parent: {json.dumps(turns)} ms; equal "
              f"outputs; {card}", flush=True)

    # ---- the programs on the corpus -----------------------------------
    pin6 = json.loads((root / FILE_PINS).read_text())["gzip"]["6"]
    prog_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "corpus.bin"
        path.write_bytes(corpus)
        for mod in (pk, dd, fsm):
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        if pgz.main(["gzip", "-k", "-6", "--tpu", str(path)]) != 0:
            raise AssertionError("gzip_cli --tpu -6 failed")
        gz = path.with_name("corpus.bin.gz").read_bytes()
        gz_s = time.perf_counter() - t0
        prog_launches["gzip_cli --tpu -6"] = {
            "dp_parse": pk.dp_parse.launches,
            "pack_groups": pk.pack_groups.launches}
        if (len(gz), hashlib.sha256(gz).hexdigest()) != (pin6["bytes"],
                                                         pin6["sha256"]):
            raise AssertionError("gzip_cli --tpu -6: the bytes differ from "
                                 "the JAX package's pin")
        if zlib.decompress(gz, 31) != corpus:
            raise AssertionError("gzip_cli --tpu -6 does not decode back")
        print(f"gzip_cli --tpu -6 (corpus, {len(corpus)} bytes): {len(gz)} "
              f"bytes with the JAX package's SHA-256 (file_codec_pins.json), "
              f"inflates through zlib, {gz_s:.3f} s with start-up; launches "
              f"{json.dumps(prog_launches['gzip_cli --tpu -6'])}", flush=True)
        # -e: the corpus's random part expands
        for argv in (["-s", str(CHUNK), "-e", "-C", "ours-tpu", "-D",
                      "ours-tpu"],
                     ["-s", str(CHUNK), "-e", "-D", "ours-pallas"]):
            for mod in (pk, dd, fsm):
                mod.reset_launch_counts()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = pbench.main([*argv, str(path)])
            if rc != 0 or "Compressed" not in text.getvalue():
                raise AssertionError(f"benchmark {' '.join(argv)} failed")
            key = f"benchmark {' '.join(argv[3:])}"
            prog_launches[key] = {
                "dp_parse": pk.dp_parse.launches,
                "pack_groups": pk.pack_groups.launches,
                "decode_chunks": dd.decompress_chunks_words.launches,
                "fsm_decode": fsm.decompress_chunks.launches}
            lines = [ln.strip() for ln in text.getvalue().splitlines()
                     if ln.strip().startswith(("Compressed", "Compression",
                                               "Decompression"))]
            print(f"{key} (corpus): {'; '.join(lines)}; launches "
                  f"{json.dumps(prog_launches[key])}; {card}", flush=True)
        for args, want_v in ((["-T"], zlib.crc32(corpus)),
                             (["-A", "-T"], zlib.adler32(corpus))):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = pck.main([*args, str(path)])
            if rc != 0 or text.getvalue().split()[0] != f"{want_v:08x}":
                raise AssertionError(f"checksum {' '.join(args)}: "
                                     f"{text.getvalue()!r} is not zlib's "
                                     f"{want_v:08x}")
        print("checksum -T and -A -T (corpus): equal to zlib's CRC-32 and "
              "Adler-32", flush=True)
        if prog_launches["benchmark -C ours-tpu -D ours-tpu"]["fsm_decode"] \
                != nchunks or prog_launches["benchmark -D ours-pallas"][
                    "decode_chunks"] != nchunks:
            raise AssertionError(f"the programs' decoders: launches "
                                 f"{prog_launches}")

        # ---- a device trace of one lean call --------------------------
        po.compress_chunks_lean(batch0, lengths, bfinal)
        torch.cuda.synchronize()
        tdir = Path(tmp) / "trace"
        with device_trace(str(tdir)) as prof:
            po.compress_chunks_lean(batch0, lengths, bfinal)
            torch.cuda.synchronize()
        (trace_file,) = tdir.glob("trace_*.json")
        ops, idle, window_ms, n_ops = trace_summary(trace_file)
        print(f"device_trace of one compress_chunks_lean call (B = "
              f"{batch0.shape[0]} x {CHUNK}): traced window "
              f"{window_ms:.3f} ms, device idle share {idle:.6f}, {n_ops} "
              f"device ops (kernels, copies, memsets); top "
              f"{len(ops)} device ops by self time [name, ms, count]: "
              f"{json.dumps(ops)}; {card}", flush=True)
        avg = prof.key_averages()
        key = ("self_device_time_total" if hasattr(avg[0],
               "self_device_time_total") else "self_cuda_time_total")
        top = sorted(avg, key=lambda e: -getattr(e, key))[:15]
        print("device_trace, profiler ops by self CUDA time [op, ms, calls]: "
              + json.dumps([[e.key[:60], round(getattr(e, key) / 1e3, 6),
                             e.count] for e in top]), flush=True)
    print(f"fsm phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    top_k = int(chain[0].argmax())
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": 1e3 * plain_s, "chain": chain, "top": top_k,
            "programs": prog_launches, "rate": rate, "idle": idle,
            "turns": turns}


def cpu_model() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (its model name, else its
    vendor and model numbers), with the architecture and CPU count."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name") or ", ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                     "CPU implementer", "CPU part")
        if k in fields) or "no model in /proc/cpuinfo"
    return f"{name} ({platform.machine()}, {os.cpu_count()} CPUs)"


def best_call(fn, passes: int):
    """(fn()'s result, best host seconds over ``passes`` calls)."""
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def require_pin(name: str, out: bytes, pin: dict) -> None:
    got = {"bytes": len(out), "sha256": hashlib.sha256(out).hexdigest()}
    if got != pin:
        raise AssertionError(f"host contract, {name}: {got}; the JAX "
                             f"package gives {pin}")


def require_round_trip(name: str, d, stream: bytes, data: bytes, fmt: str,
                       passes: int) -> float:
    """Decode ``stream`` by ``d`` in both size modes; each must give
    (SUCCESS, data, len(stream), len(data)).  Returns the known-size
    decode's best seconds."""
    want = (0, data, len(stream), len(data))
    got, secs = best_call(lambda: d.decompress(stream, len(data), fmt, True),
                          passes)
    if got != want or d.decompress(stream, len(data), fmt, False) != want:
        raise AssertionError(f"host contract, {name}: {fmt} does not decode "
                             f"back in both size modes")
    return secs


def host_contract_phase(root: Path, corpus: bytes, chunks: np.ndarray,
                        card: str) -> dict:
    """The libdeflate contract (``Compressor``, ``Decompressor``, the host
    checksums) on the host engine, held to the JAX package's pinned
    answers (``experiments/host_engine_pins.json``) on the native codec and
    on the forced Python path, and crossed with the card: K3 decodes the
    engine's chunk streams, the host ``Decompressor`` decodes
    ``gzip_compress_dp``'s output (K1, K2), and the host checksums equal
    zlib and the device ones.  Returns the phase's launches and K3's
    largest difference from its plain version."""
    import libdeflate_tpu_torch as lt
    from libdeflate_tpu_torch import native_backend as nb
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.experiments import host_contract as hc
    from libdeflate_tpu_torch.ops import checksums as ck
    from libdeflate_tpu_torch.parallel import file_codec as fc
    from libdeflate_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    pk.reset_launch_counts()
    dd.reset_launch_counts()
    pins = json.loads((root / HOST_PINS).read_text())
    cpu = cpu_model()
    label = f"host CPU {cpu}; {card}"
    cached = nb._cached_build_usable()
    t0 = time.perf_counter()
    if not nb.available():
        raise AssertionError("host contract: the native codec did not build "
                             "or load")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    print(f"host contract: native codec {'loaded' if cached else 'built'} "
          f"in {time.perf_counter() - t0:.3f} s into {nb._SO}; {gxx}; CPU "
          f"{cpu}", flush=True)
    d = lt.Decompressor()

    # the native codec: raw DEFLATE of the corpus, the formats on 1 MiB
    head = corpus[:hc.FORMAT_SPAN]
    with hc.on_backend("native", nb):
        for level in hc.LEVELS:
            c = lt.Compressor(level)
            pin_level = str(c.get_compression_level())
            passes = 3 if level in HOST_BEST_OF_3 else 1
            out, c_s = best_call(lambda: c.deflate_compress(corpus), passes)
            require_pin(f"native raw, level {level}", out,
                        pins["native"]["raw"][pin_level])
            d_s = require_round_trip(f"native, level {level}", d, out,
                                     corpus, "deflate", passes)
            for fmt in hc.FORMATS:
                f_out = c.compress(head, fmt)
                require_pin(f"native {fmt}, level {level}", f_out,
                            pins["native"]["formats"][fmt][str(level)])
                require_round_trip(f"native, level {level}", d, f_out, head,
                                   fmt, 1)
            print(f"host contract, native, level {level}: compress "
                  f"{len(corpus) / c_s / 1e6:.6f} MB/s, decompress "
                  f"{len(corpus) / d_s / 1e6:.6f} MB/s of output "
                  f"({'best of 3 calls' if passes == 3 else 'one call'} on "
                  f"{len(corpus)} bytes: {c_s:.6f} s, {d_s:.6f} s), "
                  f"{len(out)} bytes, equal to the JAX package's pin; the "
                  f"three formats of {len(head)} bytes equal theirs; each "
                  f"decodes back in both size modes; {label}", flush=True)

    # the Python path, forced as the CPU tests force it
    with hc.on_backend("python", nb):
        for level in hc.PY_LEVELS + hc.PY_OPT_LEVELS:
            data = corpus[:hc.PY_SPAN if level in hc.PY_LEVELS
                          else hc.PY_OPT_SPAN]
            c = lt.Compressor(level)
            passes = 3 if level in HOST_BEST_OF_3 else 1
            out, c_s = best_call(lambda: c.deflate_compress(data), passes)
            require_pin(f"Python raw, level {level}", out,
                        pins["python"][str(level)])
            d_s = require_round_trip(f"Python, level {level}", d, out, data,
                                     "deflate", passes)
            print(f"host contract, Python path, level {level}: compress "
                  f"{len(data) / c_s / 1e6:.6f} MB/s, decompress "
                  f"{len(data) / d_s / 1e6:.6f} MB/s of output "
                  f"({'best of 3 calls' if passes == 3 else 'one call'} on "
                  f"{len(data)} bytes: {c_s:.6f} s, {d_s:.6f} s), "
                  f"{len(out)} bytes, equal to the JAX package's pin; "
                  f"decodes back in both size modes; {label}", flush=True)

    # (a) K3 decodes the native engine's streams of each 1 MiB chunk
    dev = torch.device("cuda", 0)
    nchunks = len(chunks)
    chunks_d = torch.as_tensor(chunks.copy(), device=dev)
    full = torch.full((nchunks,), CHUNK, dtype=torch.int32, device=dev)
    err_dec = 0
    with hc.on_backend("native", nb):
        for level in CROSS_LEVELS:
            c = lt.Compressor(level)
            streams = [c.deflate_compress(ch.tobytes()) for ch in chunks]
            words, clen = dd.pack_streams(streams)
            words = torch.as_tensor(words.view(np.int32), device=dev)
            clen_d = torch.as_tensor(clen, device=dev)
            out, st, ol, cons = dd.decompress_chunks_words(words, clen_d,
                                                           full, CHUNK)
            if not (bool((st == 0).all()) and bool((ol == CHUNK).all())
                    and torch.equal(cons, clen_d)
                    and torch.equal(out, chunks_d)):
                raise AssertionError(f"host contract: K3 does not decode "
                                     f"the level-{level} chunk streams")
            rows = torch.as_tensor(CROSS_PLAIN_CHUNKS, device=dev)
            want = dd.decompress_chunks_words(
                words[rows].cpu(), clen[CROSS_PLAIN_CHUNKS],
                np.full(len(rows), CHUNK, np.int32), CHUNK, device="cpu")
            err_dec = max(err_dec, require_equal(
                f"decode_chunks (host contract, level {level})",
                [g[rows].cpu() for g in (out, st, ol, cons)], want))
            print(f"host contract, K3 on Compressor({level}) chunk streams: "
                  f"all {nchunks} decode to the corpus in one known-size "
                  f"call, status 0, consumed = stream lengths "
                  f"({int(clen.sum())} bytes); chunks {CROSS_PLAIN_CHUNKS} "
                  f"equal the plain version", flush=True)

    # (b) the host Decompressor decodes gzip_compress_dp's output (K1, K2)
    mesh = pm.make_chunk_mesh()
    gz = fc.gzip_compress_dp(corpus, mesh, CHUNK, 6)
    torch.cuda.synchronize()
    for backend in ("native", "python"):
        with hc.on_backend(backend, nb):
            (res, out, ain, aout), secs = best_call(
                lambda: d.gzip_decompress(gz, len(corpus), True), 1)
        if (res, out, ain, aout) != (0, corpus, len(gz), len(corpus)):
            raise AssertionError(f"host contract: the {backend} "
                                 f"Decompressor does not decode "
                                 f"gzip_compress_dp's level-6 output")
        print(f"host contract, {backend} gzip_decompress of "
              f"gzip_compress_dp(corpus, level 6) ({len(gz)} bytes): the "
              f"corpus, actual_in = {ain}, "
              f"{len(corpus) / secs / 1e6:.6f} MB/s of output (one call); "
              f"{label}", flush=True)
    launches = {"dp_parse": pk.dp_parse.launches,
                "pack_groups": pk.pack_groups.launches,
                "decode_chunks": dd.decompress_chunks_words.launches}
    ndev = len(mesh.devices)
    want = {"dp_parse": FILE_LEVELS[6][1] * ndev, "pack_groups": ndev,
            "decode_chunks": len(CROSS_LEVELS)}
    if launches != want:
        raise AssertionError(f"host contract: launches {launches}, not "
                             f"{want}")

    # (c) the host checksums, zlib's and the device's, per chunk
    lengths = torch.full((nchunks,), CHUNK, dtype=torch.int64, device=dev)
    dev_crc = ck.crc32_chunks(chunks_d, lengths, dev).tolist()
    dev_adler = ck.adler32_chunks(chunks_d, lengths, dev).tolist()
    sums = {}
    with hc.on_backend("native", nb):
        sums["native"] = [(lt.crc32(ch), lt.adler32(ch)) for ch in chunks]
    with hc.on_backend("python", nb):
        sums["python"] = [(lt.crc32(chunks[i]), lt.adler32(chunks[i]))
                          if i in CROSS_PLAIN_CHUNKS else sums["native"][i]
                          for i in range(nchunks)]
    ref = [(zlib.crc32(ch), zlib.adler32(ch)) for ch in chunks]
    if not sums["native"] == sums["python"] == ref == list(zip(dev_crc,
                                                               dev_adler)):
        raise AssertionError("host contract: the host, zlib and device "
                             "checksums disagree")
    print(f"host contract: lt.crc32 and lt.adler32 of each of the "
          f"{nchunks} chunks (native; the Python path on chunks "
          f"{CROSS_PLAIN_CHUNKS}) equal zlib's and crc32_chunks/"
          f"adler32_chunks on the card", flush=True)

    # the damaged set's Decompressor 4-tuples, on both backends
    with hc.on_backend("native", nb):
        cases = hc.damaged_set(lt, corpus)
    for backend in ("native", "python"):
        with hc.on_backend(backend, nb):
            if hc.decode_tuples(lt, cases) != pins["damaged"][backend]:
                raise AssertionError(f"host contract: the {backend} "
                                     f"Decompressor's tuples on the damaged "
                                     f"set differ from the JAX package's")
    print(f"host contract: the {len(cases)} damaged streams' 4-tuples in "
          f"both size modes equal the JAX package's on both backends",
          flush=True)
    print(f"host contract launches: {json.dumps(launches)}", flush=True)
    print(f"host contract phase: {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return {"launches": launches, "max_abs_err": err_dec}


def scan_phase(batches, lengths, bfinal, card: str) -> dict:
    """C1 (``csrc/commit_fsm.cu``) and C2 (``csrc/code_lens.cu``), the
    kernels of the compress paths' two loops, held to their plain
    versions (run on the CPU, where their loops of small ops are
    quicker): C1 on every commit of one lean pass (K1's span and dist,
    seg 1024) and of one dyn1 pass (the greedy parser's, seg 512), on
    one lane a chunk from real entry calls (lean on a 99 800-byte and a
    2 500-byte chunk: seg = n_pad, 99 840 and 2 560; dyn1 on a 300-byte
    chunk: seg 384), on random-length chunks (1 byte to 1 MiB) of the
    soak payload classes through lean and dyn1, and on
    ``experiments/crafted_scan.py``'s segments (512, 1024, and 2600 and
    4608 across the kernel's windows); C2 on the histograms of every
    ``build_code_lens_pair`` call of one lean pass (refine 0, 11 bits),
    one optfast pass (refine 16, 15 bits, two builds a call) and one dyn2
    pass, on crafted_scan's histograms at both configurations (rows of
    286, 30 and 512 symbols; nine rows) and on counts up to 2^30.  A CUDA
    graph captured around one wrapper call holds its one kernel node.
    Times on the lean call's inputs (and C1 on dyn1's, C2 on optfast's),
    by CUDA events: the wrapper, its bare launch (also by graph replay),
    and the plain version on the card in turns with it (kernel, plain,
    plain, kernel).  Returns the largest errors, times and bounds."""
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.experiments import crafted_scan as cs
    from libdeflate_tpu_torch.experiments.harness import record_calls
    from libdeflate_tpu_torch.experiments.timing import cuda_ms, graph_ms
    t_phase = time.perf_counter()
    dev = lengths.device

    def record(name, entry, bs=batches, ls=lengths, bf=bfinal):
        calls = []
        for b in bs:
            calls += record_calls(sk, name, lambda: entry(b, ls, bf))[1]
        return calls

    def on_cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)

    commit_sets = {f"lean pass, call {i + 1}": a for i, a in
                   enumerate(record("commit_fsm", po.compress_chunks_lean))}
    commit_sets.update({f"dyn1 pass, call {i + 1}": a for i, a in enumerate(
        record("commit_fsm", pd.compress_chunks_dynamic))})
    # one lane a chunk: n_pad is not a multiple of DP_SEG (or below 512)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for n, entry, tier in ((99800, po.compress_chunks_lean, "lean"),
                           (2500, po.compress_chunks_lean, "lean"),
                           (300, pd.compress_chunks_dynamic, "dyn1")):
        b = batches[0][:1, :n].contiguous()
        (args,) = record("commit_fsm", entry, [b],
                         torch.full((1,), n, dtype=torch.int64,
                                    device=dev), one)
        if args[3] != args[0].shape[1]:
            raise AssertionError(f"{tier} on {n} bytes committed at seg "
                                 f"{args[3]}, not one lane a chunk")
        commit_sets[f"{tier}, one {n}-byte chunk, seg {args[3]}"] = args
    # random-length chunks of the soak payload classes (scripts/tpu_soak.py)
    rng = np.random.default_rng(0xF00D)
    for k in range(2):
        bufs = np.zeros((BATCH, CHUNK), np.uint8)
        lens = np.zeros(BATCH, np.int64)
        for i in range(BATCH):
            n = int(rng.integers(1, CHUNK + 1)) if rng.random() < 0.5 \
                else CHUNK
            p = cs.soak_payload(rng, (k * BATCH + i) % 5, n)
            bufs[i, :n] = np.frombuffer(p, np.uint8)
            lens[i] = n
        sb = torch.as_tensor(bufs, device=dev)
        sl = torch.as_tensor(lens, device=dev)
        for tier, entry in (("lean", po.compress_chunks_lean),
                            ("dyn1", pd.compress_chunks_dynamic)):
            (args,) = record("commit_fsm", entry, [sb], sl, bfinal)
            commit_sets[f"soak batch {k + 1} (lengths {lens.tolist()}), "
                        f"{tier}"] = args
    for name, arrs in cs.commit_sets().items():
        t = tuple(torch.as_tensor(a, device=dev) for a in arrs)
        for seg in cs.COMMIT_SEGS:
            commit_sets[f"crafted: {name}, seg {seg}"] = t + (seg,)
    for name, (*arrs, seg) in cs.commit_long_sets().items():
        commit_sets[f"crafted: {name}"] = tuple(
            torch.as_tensor(a, device=dev) for a in arrs) + (seg,)
    err_c1 = 0
    for name, args in commit_sets.items():
        err_c1 = max(err_c1, require_equal(
            f"commit_fsm ({name})", on_cpu(sk.commit_fsm(*args)),
            sk.greedy_commit_merge(*on_cpu(args))))
    print(f"C1 commit_fsm: equal to its plain version on {len(commit_sets)} "
          f"sets (every commit of a lean pass at seg 1024 and of a dyn1 "
          f"pass at seg 512; one lane a chunk at seg 99840, 2560 and 384; "
          f"four batches of soak payloads through lean and dyn1; "
          f"crafted_scan's segments at 512, 1024, 2600 and 4608)",
          flush=True)

    lens_sets = {}
    for tier, entry in (("lean", po.compress_chunks_lean),
                        ("optfast", po.compress_chunks_optfast),
                        ("dyn2", pd.compress_chunks_dynamic2)):
        for i, a in enumerate(record("code_lens", entry)):
            lens_sets[f"{tier} pass, build {i + 1}"] = a
    hists = dict(cs.hist_sets())
    hists.update(cs.hist_sets_other())
    big = rng.integers(0, 1 << 30, (6, cs.NSYM))
    big[:, ::3] = 0
    big[1] = rng.integers(1, 5, cs.NSYM)
    big[2, :2] = (1 << 30) - 1
    hists["counts up to 2^30 (64-bit sort keys)"] = big
    for name, hist in hists.items():
        for cfg in cs.CODE_LENS_CFGS:
            lens_sets[f"crafted: {name}, refine {cfg[0]}, {cfg[1]} bits"] = (
                torch.as_tensor(hist, device=dev), *cfg)
    err_c2 = 0
    for name, args in lens_sets.items():
        err_c2 = max(err_c2, require_equal(
            f"code_lens ({name})", on_cpu(sk.code_lens(*args)),
            sk.build_code_lens(*on_cpu(args))))
    print(f"C2 code_lens: equal to its plain version on {len(lens_sets)} "
          f"sets (every build of a lean, an optfast and a dyn2 pass, "
          f"crafted_scan's histograms of 286, 30 and 512 symbols and nine "
          f"rows, counts up to 2^30, at refine 0 / 11 bits and 16 / 15)",
          flush=True)

    lean_c1 = commit_sets["lean pass, call 1"]
    lean_c2 = lens_sets["lean pass, build 1"]
    for name, fn in (("commit_fsm", lambda: sk.commit_fsm(*lean_c1)),
                     ("code_lens", lambda: sk.code_lens(*lean_c2))):
        ops = graph_node_types(fn)
        if ops != ["kernel"]:
            raise AssertionError(f"{name}: one call's graph is {ops}, not "
                                 f"its one kernel launch")
    print("C1, C2 wrappers, device ops of one call (CUDA graph nodes): "
          "[\"kernel\"] each", flush=True)

    def times(fn, bare, plain):
        turns = {"kernel": [], "plain": []}
        for who in ("kernel", "plain", "plain", "kernel"):
            turns[who].append(cuda_ms(fn, 20) if who == "kernel"
                              else cuda_ms(plain, 1))
        return {"ms": sum(turns["kernel"]) / 2,
                "kernel_ms": cuda_ms(bare, 20),
                "kernel_graph_ms": graph_ms(bare, 50),
                "plain_ms": sum(turns["plain"]) / 2, "plain_turns": turns}

    out = {"err": {"commit_fsm": err_c1, "code_lens": err_c2}}
    for name, args in (("lean", lean_c1),
                       ("dyn1", commit_sets["dyn1 pass, call 1"])):
        span, is_match, dist, seg = args
        heads = torch.empty_like(is_match)
        eff = torch.empty_like(span)
        row = times(lambda: sk.commit_fsm(*args),
                    lambda: sk.commit_fsm_into(*args, heads, eff),
                    lambda: sk.greedy_commit_merge(*args))
        # bytes: span, is_match, dist read once, heads and eff written
        # once; the carried chain: the most heads of one lane, a step each
        nbytes = span.numel() * (8 + 1 + 8 + 1 + 8)
        hmax = int(heads.reshape(-1, seg).sum(1).max())
        row.update(inputs=f"{name} pass, call 1: {list(span.shape)}, seg "
                   f"{seg}", bytes_bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
                   chain_steps=hmax, chain_bound_ms=1e3 * hmax / H100_CLOCK)
        out[f"commit_fsm {name}"] = row
        print(f"C1 commit_fsm ({name}): {json.dumps(row)}; {card}",
              flush=True)
    for name, args in (("lean", lean_c2),
                       ("optfast", lens_sets["optfast pass, build 2"])):
        hist, refine, max_len = args
        lens = torch.empty_like(hist)
        ok = torch.empty(hist.shape[0], dtype=torch.bool, device=dev)
        row = times(lambda: sk.code_lens(*args),
                    lambda: sk.code_lens_into(*args, lens, ok),
                    lambda: sk.build_code_lens(*args))
        # bytes: the counts read and the lengths written as int64, ok
        # once; the chain: the row with the longest shortest dependent
        # path, one step a cycle: the spend's scan and clamps, the fix
        # steps and the refinement's passes and level steps that these
        # counts take (crafted_scan.code_lens_chain)
        nbytes = hist.numel() * 16 + hist.shape[0]
        steps = cs.code_lens_chain(hist.cpu().numpy(), refine, max_len)
        chain = max(c["steps"] for c in steps)
        row.update(inputs=f"{name} pass, build: {list(hist.shape)}, refine "
                   f"{refine}, {max_len} bits",
                   bytes_bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
                   steps_by_row=steps, chain_steps=chain,
                   chain_bound_ms=1e3 * chain / H100_CLOCK)
        out[f"code_lens {name}"] = row
        print(f"C2 code_lens ({name}): {json.dumps(row)}; {card}", flush=True)
    print(f"scan phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return out


# the chain extension's wrappers (compress/chain_kernels.py) by kernel
CHAIN_KERNELS = {"chain_extend_multi": "chain_relax",
                 "chain_extend": "chain_double",
                 "chain_extend2": "chain_double"}
# the wrappers' plain versions (``<wrapper>_plain``), kept by
# guard_plain_chain before it puts guards in their place; the comparisons
# call these
PLAIN_CHAIN: dict = {}


def guard_plain_chain(ck) -> None:
    """Keep ``chain_kernels``' plain chain extensions in PLAIN_CHAIN, by
    wrapper, and put guards in their place that raise when given CUDA
    tensors: the wrappers look them up when called and take them for CPU
    tensors only, so no compress path may reach them on the card."""
    for name in CHAIN_KERNELS:
        plain = PLAIN_CHAIN.setdefault(name, getattr(ck, name + "_plain"))

        def guard(*args, _name=name, _plain=plain, **kw):
            first = args[0][0][0] if _name == "chain_extend_multi" \
                else args[0]
            if first.is_cuda:
                raise AssertionError(f"chain_kernels.{_name}_plain ran on "
                                     f"CUDA tensors: a compress path went "
                                     f"around C3/C4")
            return _plain(*args, **kw)
        setattr(ck, name + "_plain", guard)


def chain_counts(ck) -> dict:
    """C3's and C4's launches so far."""
    return {"chain_relax": ck.chain_extend_multi.launches,
            "chain_double": ck.chain_extend.launches
            + ck.chain_extend2.launches}


# C5's forms and probe_kernels' plain versions of them, which
# guard_plain_probe keeps in PLAIN_PROBE before it puts guards in their
# place; the comparisons call these
PROBE_PLAIN = {"best": "sorted_best", "lean": "sorted_matchfind_lean"}
PLAIN_PROBE: dict = {}


def guard_plain_probe(qk) -> None:
    """Keep ``probe_kernels``' plain versions of C5's two forms in
    PLAIN_PROBE and put guards in their place that raise when given CUDA
    tensors: the wrapper looks them up when called and takes them for CPU
    tensors only, so no compress path may reach them on the card."""
    for form, name in PROBE_PLAIN.items():
        plain = PLAIN_PROBE.setdefault(form, getattr(qk, name))

        def guard(h, *args, _name=name, _plain=plain, **kw):
            if h.is_cuda:
                raise AssertionError(f"probe_kernels.{_name} ran on CUDA "
                                     f"tensors: a compress path went around "
                                     f"C5")
            return _plain(h, *args, **kw)
        setattr(qk, name, guard)


def probe_plain(args) -> list:
    """The plain version of one C5 call (``segment_probe``'s positional
    arguments) on the same tensors, as a flat list."""
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    h, bp, seg, depth, width, form, shift = \
        tuple(args) + ("best", 0)[len(args) - 5:]
    return probe_flat(PLAIN_PROBE[form](h, qk.payload_words(bp, width, shift),
                                        seg, depth))


def probe_check(qk, args, where: str) -> int:
    """C5's wrapper on ``args`` against its plain version on the same CUDA
    tensors; its launch uncounted.  Returns the largest difference (0)."""
    n = qk.segment_probe.launches
    got = qk.segment_probe(*args)
    qk.segment_probe.launches = n
    return require_equal(f"segment_probe ({where})", probe_flat(got),
                         probe_plain(args))


def probe_counts() -> dict:
    """C5's launches so far."""
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    return {"segment_probe": qk.segment_probe.launches}


def probe_flat(out) -> list:
    """C5's result, a best triple or lean's three, as a flat list."""
    return [x for t in out for x in t] if isinstance(out[0], tuple) \
        else list(out)


def chain_flat(name: str, out) -> list:
    """A chain extension's result as a flat list of tensors."""
    return ([x for pair in out for x in pair]
            if name == "chain_extend_multi" else list(out))


def chain_check(ck, name: str, args, where: str, tile=None) -> int:
    """The wrapper ``name`` of ``ck`` on ``args`` (at ``tile``) against
    its plain version on the same CUDA tensors; its launch uncounted.
    Returns the largest difference (0)."""
    wrapper = getattr(ck, name)
    n = wrapper.launches
    got = wrapper(*args) if tile is None else wrapper(*args, tile=tile)
    wrapper.launches = n
    return require_equal(f"{CHAIN_KERNELS[name]} ({name}, {where})",
                         chain_flat(name, got),
                         chain_flat(name, PLAIN_CHAIN[name](*args)))


def chain_phase(batches, lengths, bfinal, card: str) -> dict:
    """C3 (``chain_relax``) and C4 (``chain_double``) of
    ``csrc/chain_extend.cu``, the candidates' chain extension, held to
    their plain versions on the card, exact: on every call of one batch of
    each tier that runs them (C3: lean and optfast, K = 2 over one round;
    optimal and deep, K = 5 over two rounds after the content pass; C4:
    static and dyn1 one candidate, dyn2 and dyn3 two, and the rescue pass
    of dyn2, dyn3 and deep one), on the scripts' lean triples
    (``profile_lean``'s ``chain_extend_multi`` x3 and x2), on the x3
    triples at every stride set of ``crafted_chain.STRIDE_SETS``, on
    crafted_chain's sets and shapes (rows shorter than a tile, short rows
    of several tiles) at every stride set, K = 2, 3 and 5 and tiles of 64,
    256 and 1024 positions (C4's at one and two candidates), and on
    ``crafted_chain.TALL_SHAPE``'s rows, more than a grid dimension holds
    (C3 at K = 3, C4 at one and two candidates); C3 at K = 5 on one stride
    of 684, the most a block's shared memory holds at the default tile,
    and the wrapper's ValueError at 685.  A CUDA graph captured around one
    wrapper call holds its one kernel node.
    Times on lean's inputs (C3 at K = 2, one round; also optimal's, K = 5
    over two) and dyn1's (C4, one candidate; also dyn2's, two), by CUDA
    events: the wrapper, its bare launch (also by graph replay), and the
    plain version on the card in turns with it (kernel, plain, plain,
    kernel); bounds from the bytes (each input read once, each output
    written once) and the operations (C3: 4K^2 + 3K integer operations a
    stride and position, its inner step's K adds, K compares r_k >= s,
    and for each k j = 0's compare, select, compare and two selects and
    each later j's two compares and two selects, a compare that ands in a
    predicate counting one; C4: 6 a stride and candidate pair).  The
    comparisons' launches are not counted.  Returns the largest errors,
    the times and the bounds."""
    from collections import Counter

    from libdeflate_tpu_torch.compress import bits
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import pipeline as pp
    from libdeflate_tpu_torch.experiments import crafted_chain as cc
    from libdeflate_tpu_torch.experiments import profile_lean
    from libdeflate_tpu_torch.experiments.harness import record_many
    from libdeflate_tpu_torch.experiments.timing import cuda_ms, graph_ms
    t_phase = time.perf_counter()
    dev = lengths.device
    err = {"chain_relax": 0, "chain_double": 0}
    held = Counter()

    def hold(name, args, where, tile=None):
        e = chain_check(ck, name, args, where, tile)
        err[CHAIN_KERNELS[name]] = max(err[CHAIN_KERNELS[name]], e)
        held[CHAIN_KERNELS[name]] += 1

    targets = [(ck, name) for name in CHAIN_KERNELS]
    tiers = {"lean": po.compress_chunks_lean,
             "optfast": po.compress_chunks_optfast,
             "optimal": po.compress_chunks_optimal,
             "deep": po.compress_chunks_optimal_deep,
             "static": pp.compress_chunks_static,
             "dyn1": pd.compress_chunks_dynamic,
             "dyn2": pd.compress_chunks_dynamic2,
             "dyn3": pd.compress_chunks_dynamic3}
    inputs = {}
    for tier, entry in tiers.items():
        counts = chain_counts(ck)
        _, calls = record_many(targets,
                               lambda: entry(batches[0], lengths, bfinal))
        if chain_counts(ck)["chain_relax"] - counts["chain_relax"] != len(
                calls["chain_extend_multi"]):
            raise AssertionError(f"{tier}: C3 launches and calls differ")
        for name, seen in calls.items():
            for i, args in enumerate(seen):
                hold(name, args, f"{tier}, batch 0, call {i + 1}")
                inputs.setdefault(f"{tier} {name}", args)
        print(f"C3/C4 on {tier}'s own inputs: "
              f"{json.dumps({n: len(v) for n, v in calls.items()})} calls, "
              f"each equal to its plain version", flush=True)
    for tier, wanted in (("lean", {"chain_extend_multi"}),
                         ("optimal", {"chain_extend_multi"}),
                         ("deep", {"chain_extend_multi", "chain_extend"}),
                         ("static", {"chain_extend"}),
                         ("dyn1", {"chain_extend"}),
                         ("dyn2", {"chain_extend2", "chain_extend"}),
                         ("dyn3", {"chain_extend2", "chain_extend"})):
        got = {n for n in CHAIN_KERNELS if f"{tier} {n}" in inputs}
        if got != wanted:
            raise AssertionError(f"{tier} ran the wrappers {got}, not "
                                 f"{wanted}")
    # the scripts' triples: profile_lean's x3 and x2, the x3 at every
    # stride set
    raws = list(profile_lean.posonly(batches[0], lengths))
    hold("chain_extend_multi", (raws,), "profile_lean's x3")
    hold("chain_extend_multi", (raws[:2],), "profile_lean's x2 (no C)")
    for name, (s1, s2) in cc.STRIDE_SETS.items():
        hold("chain_extend_multi", (raws, s2, s1), f"x3 triples, {name}")
    # the crafted sets at every stride set and tile
    tiles = cc.MIRROR_TILES + (ck.TILE,)
    for K in cc.RELAX_KS:
        sets = dict(cc.relax_sets(K))
        sets.update(cc.relax_shape_sets(K))
        for set_name, cands in sets.items():
            t = [tuple(torch.as_tensor(x, device=dev) for x in c)
                 for c in cands]
            for name, (s1, s2) in cc.STRIDE_SETS.items():
                want = chain_flat("chain_extend_multi",
                                  PLAIN_CHAIN["chain_extend_multi"](t, s2,
                                                                    s1))
                n = ck.chain_extend_multi.launches
                for tile in tiles:
                    err["chain_relax"] = max(err["chain_relax"], require_equal(
                        f"chain_relax (crafted: {set_name}, K = {K}, {name}, "
                        f"tile {tile})", chain_flat(
                            "chain_extend_multi",
                            ck.chain_extend_multi(t, s2, s1, tile=tile)),
                        want))
                    held["chain_relax"] += 1
                ck.chain_extend_multi.launches = n
    for nc, name in ((1, "chain_extend"), (2, "chain_extend2")):
        sets = dict(cc.double_sets(nc))
        sets.update(cc.double_shape_sets(nc))
        for set_name, cands in sets.items():
            args = tuple(torch.as_tensor(x, device=dev) for c in cands
                         for x in c)
            for tile in tiles:
                hold(name, args, f"crafted: {set_name}, tile {tile}", tile)
    # more rows than a grid dimension holds (65535), at the default tile
    tall = {"C3": cc.relax_shape_sets(3, {"tall": cc.TALL_SHAPE})["tall"],
            "C4": cc.double_shape_sets(2, {"tall": cc.TALL_SHAPE})["tall"]}
    t = [tuple(torch.as_tensor(x, device=dev) for x in c)
         for c in tall["C3"]]
    hold("chain_extend_multi", (t,), f"crafted: {cc.TALL_SHAPE} rows, K = 3")
    t = [torch.as_tensor(x, device=dev) for c in tall["C4"] for x in c]
    hold("chain_extend", tuple(t[:3]), f"crafted: {cc.TALL_SHAPE} rows")
    hold("chain_extend2", tuple(t), f"crafted: {cc.TALL_SHAPE} rows")
    # the edge of C3's domain: K = 5 on the most one stride can be
    edge = [tuple(torch.as_tensor(x, device=dev) for x in c)
            for c in next(iter(cc.relax_sets(5).values()))]
    hold("chain_extend_multi", (edge, (684,), ()),
         "crafted: K = 5, one stride of 684")
    try:
        ck.chain_extend_multi(edge, (685,), ())
    except ValueError as e:
        if "shared memory" not in str(e):
            raise
    else:
        raise AssertionError("C3 took one stride of 685 at K = 5")
    print(f"C3 chain_relax, C4 chain_double: equal to their plain versions "
          f"on {json.dumps(dict(held))} calls (every call of one batch of "
          f"lean, optfast, optimal, deep, static, dyn1, dyn2 and dyn3; "
          f"profile_lean's x3 and x2; the x3 triples at "
          f"{len(cc.STRIDE_SETS)} stride sets; crafted_chain's sets and "
          f"shapes at every stride set, K = {cc.RELAX_KS} and C4's one and "
          f"two candidates, tiles {tiles}; {cc.TALL_SHAPE[0]} rows at the "
          f"default tile; K = 5 at one stride of 684)", flush=True)

    lean = inputs["lean chain_extend_multi"]
    dyn1 = inputs["dyn1 chain_extend"]
    for name, fn in (("chain_relax", lambda: ck.chain_extend_multi(*lean)),
                     ("chain_double", lambda: ck.chain_extend(*dyn1))):
        ops = graph_node_types(fn)
        if ops != ["kernel"]:
            raise AssertionError(f"{name}: one call's graph is {ops}, not "
                                 f"its one kernel launch")
    print("C3, C4 wrappers, device ops of one call (CUDA graph nodes): "
          "[\"kernel\"] each", flush=True)

    def times(fn, bare, plain):
        turns = {"kernel": [], "plain": []}
        for who in ("kernel", "plain", "plain", "kernel"):
            turns[who].append(cuda_ms(fn, 20) if who == "kernel"
                              else cuda_ms(plain, 1))
        return {"ms": sum(turns["kernel"]) / 2,
                "kernel_ms": cuda_ms(bare, 20),
                "kernel_graph_ms": graph_ms(bare, 50),
                "plain_ms": sum(turns["plain"]) / 2, "plain_turns": turns}

    out = {"err": err, "held": dict(held)}
    counts = {n: getattr(ck, n).launches for n in CHAIN_KERNELS}
    for tier in ("lean", "optimal"):
        args = inputs[f"{tier} chain_extend_multi"]
        cands = args[0]
        s2 = args[1] if len(args) > 1 else bits.STRIDES
        s1 = args[2] if len(args) > 2 else bits.STRIDES
        strides = tuple(s1) + tuple(s2)
        K, npos = len(cands), cands[0][0].numel()
        outs = [torch.empty_like(c[0]) for c in cands]
        row = times(lambda: ck.chain_extend_multi(*args),
                    lambda: ck.chain_relax_into(cands, strides, outs),
                    lambda: PLAIN_CHAIN["chain_extend_multi"](*args))
        nbytes = K * 32 * npos
        nops = (4 * K * K + 3 * K) * len(strides) * npos
        row.update(inputs=f"{tier}, batch 0: K = {K}, strides {strides}, "
                   f"{list(cands[0][0].shape)}",
                   bytes_bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
                   ops_bound_ms=1e3 * nops / H100_INT32_OPS_PER_S)
        out[f"chain_relax {tier}"] = row
        print(f"C3 chain_relax ({tier}): {json.dumps(row)}; {card}",
              flush=True)
    for tier, name in (("dyn1", "chain_extend"), ("dyn2", "chain_extend2")):
        args = inputs[f"{tier} {name}"]
        nc = len(args) // 3
        cands = [args[3 * i:3 * i + 3] for i in range(nc)]
        outs = [torch.empty_like(args[0]) for _ in range(nc)]
        npos = args[0].numel()
        row = times(lambda: getattr(ck, name)(*args),
                    lambda: ck.chain_double_into(cands, outs),
                    lambda: PLAIN_CHAIN[name](*args))
        nbytes = 32 * nc * npos
        nops = 6 * len(ck.DOUBLE_STRIDES) * nc * nc * npos
        row.update(inputs=f"{tier}, batch 0: {nc} candidate(s), "
                   f"{list(args[0].shape)}",
                   bytes_bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
                   ops_bound_ms=1e3 * nops / H100_INT32_OPS_PER_S)
        out[f"chain_double {tier}"] = row
        print(f"C4 chain_double ({tier}): {json.dumps(row)}; {card}",
              flush=True)
    for n, c in counts.items():
        getattr(ck, n).launches = c
    out["seconds"] = time.perf_counter() - t_phase
    print(f"chain phase: {out['seconds']:.3f} s", flush=True)
    return out

# C5's callers on one batch: C5 calls a call (the main pass of static,
# dyn1 and the lean candidates; the rescue pass of dyn2, dyn3, deep and
# levels 10-12; none where the 32-byte triple runs)
PROBE_TIERS = {"static": 1, "dyn1": 1, "dyn2": 1, "dyn3": 1, "lean": 1,
               "optfast": 1, "optimal": 0, "deep": 1, "level5": 1,
               "level8": 0, "level10": 1}
# the main path's shape: 64 chunks of 1 MiB, as one benchmark call
PROBE_MAIN_ROWS = 64


def probe_phase(root: Path, chunks: np.ndarray, batches, lengths, bfinal,
                card: str) -> dict:
    """C5 (``csrc/segment_probe.cu``), the sorted matchfind's probes
    after the sort, which replaces XLA code of the JAX package's candidate
    stage, held to its plain versions (``probe_kernels.sorted_best``,
    ``sorted_matchfind_lean`` on the payload words) on the card,
    exact: on every call of one batch of each tier (PROBE_TIERS: its
    count of calls checked), on ``experiments/crafted_probe.py``'s sets
    at every (form, depth, width) of ``crafted_probe.RUNS``, at depth 32
    (33 raises), and at the main path's shape (PROBE_MAIN_ROWS x 1 MiB,
    the corpus repeated) in level 6's lean form, dyn1's and the static
    tier's best form and the rescue pass's.  There it times by CUDA
    events the wrapper (the sort and C5) in turns with the plain version
    on the card (wrapper, plain, plain, wrapper), the bare launch (also
    by graph replay) and the sort alone, beside the bound from the bytes
    (each position's key and byte read once, 24 or 72 bytes written).
    The comparisons' launches are not counted.  Returns the largest
    error, the calls held, and the rows of times."""
    import functools as ft

    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import pipeline as pp
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.experiments import crafted_probe as cq
    from libdeflate_tpu_torch.experiments.harness import record_many
    from libdeflate_tpu_torch.experiments.timing import cuda_ms, graph_ms
    t_phase = time.perf_counter()
    dev = lengths.device
    err, held = 0, 0

    def hold(args, where):
        nonlocal err, held
        err = max(err, probe_check(qk, args, where))
        held += 1

    entries = {"static": pp.compress_chunks_static,
               "dyn1": pd.compress_chunks_dynamic,
               "dyn2": pd.compress_chunks_dynamic2,
               "dyn3": pd.compress_chunks_dynamic3,
               "lean": po.compress_chunks_lean,
               "optfast": po.compress_chunks_optfast,
               "optimal": po.compress_chunks_optimal,
               "deep": po.compress_chunks_optimal_deep,
               **{f"level{k}": ft.partial(po.compress_chunks_optimal_with,
                                          **kw)
                  for k, kw in po.MESH_LEVEL_OPTIONS.items()}}
    calls_by_tier = {}
    for tier, entry in entries.items():
        n0 = qk.segment_probe.launches
        _, calls = record_many([(qk, "segment_probe")],
                               lambda: entry(batches[0], lengths, bfinal))
        seen = calls["segment_probe"]
        if qk.segment_probe.launches - n0 != PROBE_TIERS[tier] \
                or len(seen) != PROBE_TIERS[tier]:
            raise AssertionError(f"{tier}: C5 launched "
                                 f"{qk.segment_probe.launches - n0} times "
                                 f"in {len(seen)} calls, not "
                                 f"{PROBE_TIERS[tier]}")
        for i, args in enumerate(seen):
            hold(args, f"{tier}, batch 0, call {i + 1}")
        calls_by_tier[tier] = len(seen)
    print(f"C5 on each tier's own inputs: {json.dumps(calls_by_tier)} "
          f"calls, each equal to its plain version", flush=True)
    for name, (h, bp, seg, shift) in cq.probe_sets().items():
        hd, bd = torch.as_tensor(h, device=dev), torch.as_tensor(bp,
                                                                device=dev)
        for form, depth, width in cq.RUNS:
            hold((hd, bd, seg, depth, width, form, shift),
                 f"crafted: {name}, {form}, depth {depth}, {width} bytes")
    h, bp, seg, _ = cq.probe_sets()["text, 64 KiB"]
    deep = (torch.as_tensor(h, device=dev), torch.as_tensor(bp, device=dev),
            seg, qk.MAX_DEPTH, 16, "lean", 0)
    hold(deep, f"crafted: text, 64 KiB, depth {qk.MAX_DEPTH}")
    try:
        qk.segment_probe(*deep[:3], qk.MAX_DEPTH + 1, 16, "lean")
    except ValueError as e:
        if "depth" not in str(e):
            raise
    else:
        raise AssertionError(f"C5 took depth {qk.MAX_DEPTH + 1}")
    print(f"C5 segment_probe: equal to its plain versions on the crafted "
          f"sets at {len(cq.RUNS)} runs each and at depth "
          f"{qk.MAX_DEPTH}; depth {qk.MAX_DEPTH + 1} refused", flush=True)

    reps = -(-PROBE_MAIN_ROWS // len(chunks))
    big = torch.as_tensor(np.concatenate([chunks] * reps)[:PROBE_MAIN_ROWS],
                          device=dev)
    lens = torch.full((PROBE_MAIN_ROWS,), CHUNK, dtype=torch.int64,
                      device=dev)
    rows = {}
    for what, wide, form, depth, width, half in (
            ("level 6 (lean)", True, "lean", 6, 16, False),
            ("dyn1", True, "best", 6, 16, False),
            ("static", False, "best", 2, 16, False),
            ("rescue pass", False, "best", 2, 8, True)):
        bp, _, _, _, h, seg, _, junk = pp._row_inputs(big, lens, wide)
        shift = seg // 2 if half else 0
        if half:
            h = torch.cat([h[:, shift:], torch.full_like(h[:, :shift], junk)],
                          1)
        args = (h, bp, seg, depth, width, form, shift)
        hold(args, f"main path: {what}, {PROBE_MAIN_ROWS} x 1 MiB")
        keys = qk.sort_keys(h, seg)
        outs = [torch.empty_like(h) for _ in range(qk.OUTPUTS[form])]
        n0 = qk.segment_probe.launches
        turns = {"wrapper": [], "plain": []}
        for who in ("wrapper", "plain", "plain", "wrapper"):
            turns[who].append(
                cuda_ms(lambda: qk.segment_probe(*args), 10)
                if who == "wrapper" else cuda_ms(lambda: probe_plain(args),
                                                 1))

        def bare():
            qk.segment_probe_into(bp, keys, outs, form, width, seg, depth,
                                  shift)

        npos = h.numel()
        row = {"ms": sum(turns["wrapper"]) / 2,
               "kernel_ms": cuda_ms(bare, 20),
               "kernel_graph_ms": graph_ms(bare, 20),
               "sort_ms": cuda_ms(lambda: qk.sort_keys(h, seg), 10),
               "plain_ms": sum(turns["plain"]) / 2, "turns": turns,
               "bytes_a_position": 9 + 8 * qk.OUTPUTS[form],
               "bytes_bound_ms": 1e3 * npos * (9 + 8 * qk.OUTPUTS[form])
               / H100_BYTES_PER_S,
               "inputs": f"{what}: {form}, depth {depth}, {width}-byte "
                         f"payloads, segments of {seg}, shift {shift}, "
                         f"{list(h.shape)}"}
        qk.segment_probe.launches = n0
        rows[what] = row
        print(f"C5 segment_probe ({what}): {json.dumps(row)}; {card}",
              flush=True)
        del bp, h, keys, outs, args
        torch.cuda.empty_cache()
    out = {"err": err, "held": held, "tiers": calls_by_tier, "main": rows,
           "seconds": time.perf_counter() - t_phase}
    print(f"probe phase: {out['seconds']:.3f} s, {held} calls held",
          flush=True)
    return out


def soak_fuzz_phase(root: Path, card: str) -> dict:
    """The randomized harnesses on the card.  The soak
    (``experiments/soak.py``): every tier of ``soak.TIERS``, two batches
    each (seed 0xF00D, B = 4 chunks of random length up to 1 MiB, the five
    payload classes of ``scripts/tpu_soak.py``): each chunk through zlib,
    K3 and F1 back to its payload and equal to the JAX package's
    total_bits and SHA-256 (``experiments/soak_pins.json``); every kernel
    call of the soak recorded and held to its plain version: K2 and C1 on
    every call, C2 on every call of the dynamic and DP tiers, K1 on the
    first batch of each DP tier (its plain version takes 0.4-1.2 s a
    call); then ``soak.SHORT_LENGTHS`` (chunks of 0-258 bytes) in 1 MiB
    rows, one batch through each tier, every kernel call held to its
    plain version.  The fuzz (``experiments/fuzz.py``, seed 0):
    FUZZ_ITERS trials of the host targets on the native codec, each also
    a device trial (an 8 KiB row through static and dyn1, then its zlib-6
    stream and three damaged copies through K3 in both size modes and
    F1, every row in one call a decoder, each decoder equal to its plain
    version), and an empty row with its stream whole and cut to nothing.
    The launches of the comparisons are not counted.  Returns the
    phase's launches and largest errors."""
    from collections import Counter

    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.decompress import fsm
    from libdeflate_tpu_torch.experiments import fuzz, soak
    from libdeflate_tpu_torch.experiments.harness import record_many
    t_phase = time.perf_counter()
    wrappers = {"dp_parse": pk.dp_parse, "pack_groups": pk.pack_groups,
                "commit_fsm": sk.commit_fsm, "code_lens": sk.code_lens,
                "decode_chunks": dd.decompress_chunks_words,
                "fsm_decode": fsm.decompress_chunks}
    targets = [(pk, "dp_parse"), (pk, "pack_groups"), (sk, "commit_fsm"),
               (sk, "code_lens"), (qk, "segment_probe")] + [
                   (ck, name) for name in CHAIN_KERNELS]
    err = dict.fromkeys(wrappers, 0)
    err.update(chain_relax=0, chain_double=0, segment_probe=0)
    held = Counter()
    plain_s = Counter()
    k1_tiers = []
    short = False    # K1 is held on every call of the short chunks

    def on_cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def hold(name, tier, got, plain):
        t0 = time.perf_counter()
        want = plain()
        plain_s[name] += time.perf_counter() - t0
        err[name] = max(err[name], require_equal(f"{name} (soak, {tier})",
                                                 got, want))
        held[name] += 1

    def call(tier, entry, bufs, lens, bfinal):
        res, calls = record_many(targets, lambda: entry(bufs, lens, bfinal))
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        for args in calls["pack_groups"]:
            hold("pack_groups", tier, [pk.pack_groups(*args)],
                 lambda: [pk.group_place(*args)])
        for args in calls["commit_fsm"]:
            hold("commit_fsm", tier, on_cpu(sk.commit_fsm(*args)),
                 lambda: sk.greedy_commit_merge(*on_cpu(args)))
        for args in calls["code_lens"]:
            hold("code_lens", tier, on_cpu(sk.code_lens(*args)),
                 lambda: sk.build_code_lens(*on_cpu(args)))
        if calls["dp_parse"] and (tier not in k1_tiers or short):
            k1_tiers.append(tier)
            for args in calls["dp_parse"]:
                hold("dp_parse", tier, pk.dp_parse(*args),
                     lambda: pk.dp_parse_plain(*args))
        for name in CHAIN_KERNELS:      # each restores its own count
            kern = CHAIN_KERNELS[name]
            for args in calls[name]:
                t0 = time.perf_counter()
                err[kern] = max(err[kern], chain_check(ck, name, args,
                                                       f"soak, {tier}"))
                plain_s[kern] += time.perf_counter() - t0
                held[kern] += 1
        for args in calls["segment_probe"]:   # restores its own count
            t0 = time.perf_counter()
            err["segment_probe"] = max(err["segment_probe"], probe_check(
                qk, args, f"soak, {tier}"))
            plain_s["segment_probe"] += time.perf_counter() - t0
            held["segment_probe"] += 1
        for name, w in wrappers.items():
            w.launches = counts[name]
        return res

    def chain_launches():
        return {**chain_counts(ck), "chain_extend2": ck.chain_extend2.launches,
                **probe_counts()}

    # C3 a DP tier's call; C4 a greedy call, dyn2's and dyn3's A/B one and
    # the rescue pass of dyn2, dyn3 and deep; C5 a call of static, dyn1,
    # lean and optfast and the rescue pass of dyn2, dyn3 and deep
    chain_want = {"chain_relax": 5, "chain_double": 7, "chain_extend2": 2,
                  "segment_probe": 7}
    for mod in (pk, sk, dd, fsm, ck, qk):
        mod.reset_launch_counts()
    pins = json.loads((root / SOAK_PINS).read_text())
    res = soak.run(SOAK_BATCHES, SOAK_SEED, soak.TIERS, pins=pins, call=call,
                   log=functools.partial(print, flush=True))
    launches = {"soak": {name: w.launches for name, w in wrappers.items()}}
    per = SOAK_BATCHES // len(soak.TIERS)
    chain_soak = chain_launches()
    if chain_soak != {k: per * v for k, v in chain_want.items()}:
        raise AssertionError(f"soak: C3/C4 launches {chain_soak}")
    passes = {name: po.TIERS[name]["passes"] for name in
              ("lean", "optfast", "optimal", "optimal2", "deep")}

    def want(per):
        """The launches of per calls a tier: one pack a call, a commit
        a greedy call or cost pass, a build but on static, one K3 and one
        F1 call a batch."""
        return {"dp_parse": per * sum(passes.values()),
                "pack_groups": per * len(soak.TIERS),
                "commit_fsm": per * (4 + sum(passes.values())),
                "code_lens": per * (3 + sum(passes.values())),
                "decode_chunks": per * len(soak.TIERS),
                "fsm_decode": per * len(soak.TIERS)}

    if launches["soak"] != want(SOAK_BATCHES // len(soak.TIERS)):
        raise AssertionError(f"soak launches {launches['soak']}")
    if held["dp_parse"] != sum(passes.values()) or k1_tiers != list(passes):
        raise AssertionError(f"K1 held to its plain version on {k1_tiers}, "
                             f"{held['dp_parse']} calls")
    print(f"soak: {res['chunks']} chunks of {len(soak.TIERS)} tiers, each "
          f"through zlib, K3 and F1 and equal to its pinned JAX total_bits "
          f"and SHA-256; lengths {min(map(min, res['lengths']))} to "
          f"{max(map(max, res['lengths']))} bytes, "
          f"{sum(n < soak.N for row in res['lengths'] for n in row)} below "
          f"1 MiB; kernel calls held to their plain versions "
          f"{json.dumps(dict(held))} (K1 on the first batch of "
          f"{', '.join(k1_tiers)}); launches {json.dumps(launches['soak'])}; "
          f"{res['seconds']:.3f} s; {card}", flush=True)
    soak_held = dict(held)
    launches["soak"].update(chain_soak)
    # chunks of 0-258 bytes in 1 MiB rows, one batch a tier, K1 held to
    # its plain version on all of their calls
    for mod in (pk, sk, dd, fsm, ck, qk):
        mod.reset_launch_counts()
    short = True
    t0 = time.perf_counter()
    payloads = soak.short_payloads()
    for tier in soak.TIERS:
        soak.soak_batch(tier, payloads, torch.device("cuda", 0), soak.N,
                        call)
    launches["short"] = {name: w.launches for name, w in wrappers.items()}
    if launches["short"] != want(1) or chain_launches() != chain_want:
        raise AssertionError(f"short chunks: launches {launches['short']}, "
                             f"{chain_launches()}")
    launches["short"].update(chain_launches())
    print(f"soak, short chunks: lengths {list(soak.SHORT_LENGTHS)} in "
          f"{soak.N}-byte rows, B = {len(payloads)}, through all "
          f"{len(soak.TIERS)} "
          f"tiers: zlib, K3 and F1 give every payload back; kernel calls "
          f"held to their plain versions "
          f"{json.dumps({k: held[k] - soak_held.get(k, 0) for k in held})}; "
          f"launches {json.dumps(launches['short'])}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    for mod in (pk, sk, dd, fsm, ck, qk):
        mod.reset_launch_counts()
    fz = fuzz.run(FUZZ_ITERS, FUZZ_SEED, 1,
                  log=functools.partial(print, flush=True))
    # an empty row (gen_data draws length 0 once in 8192): static and dyn1
    # on it, and its stream whole and cut to nothing through the decoders
    dev = torch.device("cuda", 0)
    fuzz.compress_row(b"", dev)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    empty = fuzz.device_rows([(b"", [("clean", c.compress(b"") + c.flush()),
                                     ("cut", b"")])], dev)
    launches["fuzz"] = {name: w.launches for name, w in wrappers.items()}
    launches["fuzz"].update(chain_launches())
    c = fz["counts"]
    if c["damaged"] < 64 or c["device compress rows"] < 16:
        raise AssertionError(f"fuzz: {c['damaged']} damaged rows and "
                             f"{c['device compress rows']} compress rows")
    for name in ("pack_groups", "commit_fsm", "code_lens", "decode_chunks",
                 "fsm_decode", "chain_double", "segment_probe"):
        if launches["fuzz"][name] <= 0:
            raise AssertionError(f"the fuzz's device target never launched "
                                 f"{name}")
    rejects = {name: c.get(f"{name}: success zlib rejects", 0)
               for name in fuzz.DECODERS}
    print(f"fuzz: {FUZZ_ITERS} trials (seed {FUZZ_SEED}) of the host targets "
          f"on the native codec and of the device target; "
          f"{c['device compress rows']} rows of {min(fz['row_lengths'])} to "
          f"{max(fz['row_lengths'])} bytes through static and dyn1; "
          f"{c['rows']} decoder rows ({c['damaged']} damaged) through K3 "
          f"(both size modes) and F1, each equal to its plain version; "
          f"device successes that zlib rejects {json.dumps(rejects)}; an "
          f"empty row through static and dyn1 and its stream, whole and cut "
          f"to nothing, through the decoders "
          f"{json.dumps(dict(sorted(empty.items())))}; "
          f"counts {json.dumps(dict(sorted(c.items())))}; launches "
          f"{json.dumps(launches['fuzz'])}; {fz['seconds']:.3f} s (decoders "
          f"and their plain versions {fz['decode_seconds']:.3f} s)",
          flush=True)
    print(f"soak-and-fuzz phase: {time.perf_counter() - t_phase:.3f} s, of "
          f"which the plain versions of the soak's and the short chunks' "
          f"kernel calls "
          f"{json.dumps({k: round(v, 3) for k, v in plain_s.items()})} s",
          flush=True)
    return {"launches": launches, "max_abs_err": err}


DRIVER_PINS = "libdeflate_tpu_torch/experiments/ratio_total_bits.json"
DRIVER_CHECKSUM_ROWS = 64       # 64 x 1 MiB through the checksums


def drivers_phase(root: Path, corpus: bytes, card: str) -> dict:
    """The ported measurement and ratio drivers of ``scripts/``, each in
    its short form (reps 1): the stage profilers ``profile_lean`` and
    ``profile_opt`` on one batch of B = 4 x 1 MiB (the profiled chain's
    stream through zlib and K3 back to the input, the FULL lines through
    zlib; K1, K2, C1 and C2 on a recorded call each held to their plain
    versions), ``ablate_lean``'s eight ablations on the corpus's first
    batch (each chunk's total_bits and SHA-256 equal to the JAX package's,
    ``experiments/ratio_total_bits.json``; K1 on the second cost pass's
    per-chunk tables held to its plain version), ``probe_prims``, every
    configuration of ``ratio_ab``, ``exp_corpus2_breadth``,
    ``exp_match_bias``, ``exp_r5_speed``, ``exp_dp_corpus`` and
    ``exp_ratio_gap`` on the first 1 MiB chunk of the corpus and of the
    second corpus's text part (total_bits and SHA-256 equal to the pins,
    every stream through zlib), ``exp_ratio_gap``'s re-costing of those
    chunks (equal to the pins), ``exp_text_gap_diag`` on one chunk, and
    the checksum probes on 64 x 1 MiB (every row equal to zlib's, K3 on
    16 zlib-6 chunks, the CRC's sub-stages in a CUDA graph).  The counts
    are set to 0 before the drivers run and read after; the comparisons'
    launches are not counted.  Returns the launches and largest
    errors."""
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import pipeline as pp
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.experiments import (ablate_lean,
                                                  exp_checksum_decode,
                                                  exp_corpus2_breadth,
                                                  exp_crc_profile,
                                                  exp_dp_corpus,
                                                  exp_match_bias,
                                                  exp_r5_speed,
                                                  exp_ratio_gap,
                                                  exp_text_gap_diag,
                                                  probe_prims, profile_lean,
                                                  profile_opt, ratio_ab)
    from libdeflate_tpu_torch.experiments import corpus as pc
    from libdeflate_tpu_torch.experiments.driver_common import on_device
    from libdeflate_tpu_torch.experiments.harness import record_many
    from libdeflate_tpu_torch.experiments.soak import FINAL_TAIL
    from libdeflate_tpu_torch.ops.checksums import (adler32_chunks,
                                                    crc32_chunks)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    pins = json.loads((root / DRIVER_PINS).read_text())
    wrappers = {"dp_parse": pk.dp_parse, "pack_groups": pk.pack_groups,
                "commit_fsm": sk.commit_fsm, "code_lens": sk.code_lens,
                "decode_chunks": dd.decompress_chunks_words}
    targets = [(pk, "dp_parse"), (pk, "pack_groups"), (sk, "commit_fsm"),
               (sk, "code_lens"), (qk, "segment_probe")] + [
                   (ck, name) for name in CHAIN_KERNELS]
    err = dict.fromkeys(wrappers, 0)
    err.update(chain_relax=0, chain_double=0, segment_probe=0)
    held = dict.fromkeys(err, 0)
    plain_s = 0.0

    def on_cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def hold(calls, where, k1_index=0):
        """The first recorded call of each kernel (K1's ``k1_index``-th)
        against its plain version, the comparisons' launches uncounted."""
        nonlocal plain_s
        counts = {name: w.launches for name, w in wrappers.items()}
        t0 = time.perf_counter()
        checks = {
            "dp_parse": lambda a: (pk.dp_parse(*a), pk.dp_parse_plain(*a)),
            "pack_groups": lambda a: ([pk.pack_groups(*a)],
                                      [pk.group_place(*a)]),
            "commit_fsm": lambda a: (on_cpu(sk.commit_fsm(*a)),
                                     sk.greedy_commit_merge(*on_cpu(a))),
            "code_lens": lambda a: (on_cpu(sk.code_lens(*a)),
                                    sk.build_code_lens(*on_cpu(a)))}
        for name, check in checks.items():
            seen = calls[name]
            if not seen:
                continue
            args = seen[k1_index if name == "dp_parse" else 0]
            got, want = check(args)
            err[name] = max(err[name], require_equal(
                f"{name} (drivers, {where})", got, want))
            held[name] += 1
        for name, kern in CHAIN_KERNELS.items():   # every call
            for args in calls[name]:
                err[kern] = max(err[kern], chain_check(
                    ck, name, args, f"drivers, {where}"))
                held[kern] += 1
        for args in calls["segment_probe"]:          # every call
            err["segment_probe"] = max(err["segment_probe"], probe_check(
                qk, args, f"drivers, {where}"))
            held["segment_probe"] += 1
        plain_s += time.perf_counter() - t0
        for name, w in wrappers.items():
            w.launches = counts[name]

    def k3_round_trip(name, words, total_bits, rows):
        """Each stream (not final: closed by an empty final block) back
        through zlib and K3 to its row."""
        streams = []
        for k in range(rows.shape[0]):
            s = pp.device_stream_to_bytes(words[k].cpu(), int(total_bits[k]))
            if zlib.decompressobj(-15).decompress(s) != rows[k].tobytes():
                raise AssertionError(f"{name}: chunk {k} does not inflate "
                                     f"through zlib")
            streams.append(s + FINAL_TAIL)
        comp, clen = dd.pack_streams(streams)
        counts = {n: w.launches for n, w in wrappers.items()}
        out, status, olen, _ = dd.decompress_chunks_words(
            torch.as_tensor(comp.view(np.int32), device=dev),
            torch.as_tensor(clen, device=dev),
            torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32,
                       device=dev), rows.shape[1])
        for n, w in wrappers.items():
            w.launches = counts[n]
        if int(status.abs().sum()) or not np.array_equal(out.cpu().numpy(),
                                                         rows):
            raise AssertionError(f"{name}: K3 does not decode the streams "
                                 f"back")

    def pinned(name, got_bits, got_streams, want):
        for k, (bits, stream) in enumerate(zip(got_bits, got_streams)):
            digest = hashlib.sha256(stream).hexdigest()
            if [bits, digest] != want[k]:
                raise AssertionError(f"{name}: chunk {k}: total_bits {bits} "
                                     f"sha256 {digest[:16]}, the JAX package "
                                     f"{want[k][0]} {want[k][1][:16]}")

    for mod in (pk, sk, dd, ck, qk):
        mod.reset_launch_counts()
    log = functools.partial(print, flush=True)
    # ---- the stage profilers, reps 1 ------------------------------------
    lines = {}
    for mod in (profile_lean, profile_opt):
        t0 = time.perf_counter()
        res, calls = record_many(targets, lambda: mod.run(dev, reps=1,
                                                          log=log))
        hold(calls, mod.__name__.rsplit(".", 1)[1])
        rows = res["bufs"].cpu().numpy()
        k3_round_trip(f"{mod.__name__} chain", *res["outputs"]["stream"],
                      rows)
        for name, out in res["outputs"].items():
            if name.startswith("FULL"):
                w, t = out
                for k in range(rows.shape[0]):
                    s = pp.device_stream_to_bytes(w[k].cpu(), int(t[k]))
                    if zlib.decompressobj(-15).decompress(s) != \
                            rows[k].tobytes():
                        raise AssertionError(f"{name}: chunk {k}")
        lines[mod.__name__] = res["rows"]
        log(f"drivers: {mod.__name__.rsplit('.', 1)[1]}, {len(res['rows'])} "
            f"lines, the chain's stream through zlib and K3, the FULL lines "
            f"through zlib; {time.perf_counter() - t0:.3f} s; {card}")
    # ---- the ablations on the corpus's first batch ----------------------
    rows = np.frombuffer(corpus[: 4 * CHUNK], np.uint8).reshape(4, CHUNK)
    args = on_device(rows, dev)
    abl = {}
    for name in ablate_lean.ABLATIONS:
        ab = ablate_lean.ablation(name)
        if name == "none":
            (w, t), calls = record_many(
                targets, lambda: ablate_lean.lean_pipeline(*args, ab))
            hold(calls, "ablate_lean none", k1_index=1)
        else:
            w, t = ablate_lean.lean_pipeline(*args, ab)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ablate_lean.lean_pipeline(*args, ab)
        torch.cuda.synchronize()
        abl[name] = 1e3 * (time.perf_counter() - t0)
        streams = [pp.device_stream_to_bytes(w[k].cpu(), int(t[k]))
                   for k in range(4)]
        pinned(f"ablate_lean {name}", [int(x) for x in t.cpu()], streams,
               pins["ablations"][name])
        if name != "pack":
            for k in range(4):
                if zlib.decompressobj(-15).decompress(streams[k]) != \
                        rows[k].tobytes():
                    raise AssertionError(f"ablate_lean {name}: chunk {k}")
    log(f"drivers: ablate_lean, the 8 ablations' total_bits and SHA-256 "
        f"equal the JAX package's on 4 chunks; ms a batch (one call) "
        f"{json.dumps({k: round(v, 3) for k, v in abl.items()})}; {card}")
    prims = probe_prims.run(dev, reps=1, log=log)
    # ---- every ratio configuration on two chunks ------------------------
    two = np.stack([np.frombuffer(corpus[:CHUNK], np.uint8),
                    np.frombuffer(pc.make_corpus2(pc.CORPUS_BYTES, root)
                                  [:CHUNK], np.uint8)])
    args = on_device(two, dev)
    tags = ("corpus1", "c2-text")
    configs = {}
    for mod in (ratio_ab, exp_corpus2_breadth, exp_match_bias, exp_r5_speed,
                exp_dp_corpus, exp_ratio_gap):
        for name, fn in mod.CONFIGS.items():
            key = f"{mod.__name__.rsplit('.', 1)[1]}/{name}"
            w, t = fn(*args, device=dev)
            streams = [pp.device_stream_to_bytes(w[k].cpu(), int(t[k]))
                       for k in range(2)]
            pinned(key, [int(x) for x in t.cpu()], streams,
                   [pins["configs"][key][tag] for tag in tags])
            for k in range(2):
                if zlib.decompressobj(-15).decompress(streams[k]) != \
                        two[k].tobytes():
                    raise AssertionError(f"{key}: chunk {k}")
            configs[key] = [len(s) / CHUNK for s in streams]
    missing = set(pins["configs"]) - set(configs)
    if missing:
        raise AssertionError(f"pinned configurations not run: {missing}")
    log(f"drivers: {len(configs)} ratio configurations' total_bits and "
        f"SHA-256 equal the JAX package's on the first 1 MiB of the corpus "
        f"and of the second corpus's text; ratios [corpus1, c2-text] "
        f"{json.dumps({k: [round(x, 6) for x in v] for k, v in configs.items()})}")
    recost = {tag: {k: v[0] for k, v in
                    exp_ratio_gap.recost(two[i:i + 1], dev).items()}
              for i, tag in enumerate(tags)}
    want = {tag: {k: v[0] for k, v in pins["ratio_gap_recost"][tag].items()}
            for tag in tags}
    if recost != want:
        raise AssertionError(f"exp_ratio_gap re-cost {recost}, the JAX "
                             f"package {want}")
    diag = exp_text_gap_diag.diag([bytes(two[1])], dev, log=log)
    log(f"drivers: exp_ratio_gap re-cost equal to the JAX package's "
        f"{json.dumps(recost)}; exp_text_gap_diag on the second corpus's "
        f"first text chunk: native {diag[0]['native_bytes']} B, lean "
        f"{diag[0]['device_bytes']} B")
    # ---- the checksum probes on 64 x 1 MiB ------------------------------
    cs = exp_checksum_decode.checksums(dev, DRIVER_CHECKSUM_ROWS, CHUNK,
                                       reps=1, log=log)
    rng = np.random.default_rng(11)
    bufs = rng.integers(0, 256, size=(DRIVER_CHECKSUM_ROWS, CHUNK),
                        dtype=np.uint8)
    bd = torch.as_tensor(bufs, device=dev)
    lens = torch.full((DRIVER_CHECKSUM_ROWS,), CHUNK, dtype=torch.int64,
                      device=dev)
    crc = crc32_chunks(bd, lens, device=dev).cpu().tolist()
    adl = adler32_chunks(bd, lens, device=dev).cpu().tolist()
    for i in range(DRIVER_CHECKSUM_ROWS):
        if crc[i] != zlib.crc32(bufs[i].tobytes()) or \
                adl[i] != zlib.adler32(bufs[i].tobytes()):
            raise AssertionError(f"checksums: row {i} differs from zlib")
    dec = exp_checksum_decode.decode(dev, reps=1, log=log)
    crc_prof = exp_crc_profile.run(dev, DRIVER_CHECKSUM_ROWS, CHUNK, k=2,
                                   reps=1, log=log)
    if not all(v["ok"] for v in cs.values()) or not dec["ok"]:
        raise AssertionError(f"checksum probes: {cs} {dec}")
    launches = {name: w.launches for name, w in wrappers.items()}
    launches.update(chain_counts(ck))
    launches.update(probe_counts())
    for name in launches:
        if launches[name] <= 0:
            raise AssertionError(f"the drivers never launched {name}")
    log(f"drivers: checksums of {DRIVER_CHECKSUM_ROWS} x {CHUNK} bytes equal "
        f"zlib's on every row; kernel calls held to their plain versions "
        f"{json.dumps(held)} ({plain_s:.3f} s); launches "
        f"{json.dumps(launches)}; drivers phase "
        f"{time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "max_abs_err": err, "profiles": lines,
            "ablations_ms": abl, "prims": prims, "configs": configs,
            "checksums": cs, "crc_profile": crc_prof, "decode": dec}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    against = (Path(argv[argv.index("--against") + 1]).resolve()
               if "--against" in argv else None)
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from libdeflate_tpu_torch import _build
    from libdeflate_tpu_torch.compress import chain_kernels as ck
    from libdeflate_tpu_torch.compress import dynamic as pd
    from libdeflate_tpu_torch.compress import kernels as pk
    from libdeflate_tpu_torch.compress import optimal as po
    from libdeflate_tpu_torch.compress import pipeline as pp
    from libdeflate_tpu_torch.compress import probe_kernels as qk
    from libdeflate_tpu_torch.compress import scan_kernels as sk
    from libdeflate_tpu_torch.decompress import decode as dd
    from libdeflate_tpu_torch.experiments import crafted_dp as cdp
    from libdeflate_tpu_torch.experiments import crafted_streams as cs
    from libdeflate_tpu_torch.experiments import exp_device_roundup as rd
    from libdeflate_tpu_torch.experiments import exp_launch_overhead as lo
    from libdeflate_tpu_torch.experiments import exp_tokenize_ceiling as tk
    from libdeflate_tpu_torch.experiments import fsm_variants as fv
    from libdeflate_tpu_torch.experiments.corpus import make_corpus
    from libdeflate_tpu_torch.experiments.harness import (build_lines,
                                                          build_tagged,
                                                          record_calls)
    from libdeflate_tpu_torch.experiments.timing import cuda_ms, graph_ms

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    # from here on no compress path may run the plain chain extensions on
    # the card: C3 and C4 take their place
    guard_plain_chain(ck)
    # nor the plain probes of the sorted matchfind's forms C5 takes
    guard_plain_probe(qk)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(logs) or 'up to date'})", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: {'; '.join(regs)}", flush=True)

    corpus = make_corpus(CORPUS_MB << 20, root)
    nchunks = len(corpus) // CHUNK
    chunks = np.frombuffer(corpus, np.uint8).reshape(nchunks, CHUNK)
    batches = [torch.as_tensor(chunks[i:i + BATCH].copy(), device=dev)
               for i in range(0, nchunks, BATCH)]
    lengths = torch.full((BATCH,), CHUNK, dtype=torch.int64, device=dev)
    # each chunk a whole stream (final block), so that it decodes alone
    bfinal = torch.ones(BATCH, dtype=torch.bool, device=dev)

    # ---- K1: the DP kernel against its plain version -------------------
    rand_dp = cdp.random_inputs(dev)
    err_dp = require_equal("dp_parse (random)",
                           pk.dp_parse(*rand_dp, po.DP_SEG),
                           pk.dp_parse_plain(*rand_dp, po.DP_SEG))
    # the JAX test's own shape (S=256, B=2): one block spans both chunks,
    # each with its own lc table
    small = cdp.random_inputs(dev, B=2, n_pad=512)
    lc2 = torch.stack([small[-1], torch.clamp(small[-1] - 40, min=1)])
    dp_sets = {"S=256, per-chunk lc": (small[:-1] + (lc2,), 256)}
    # 15 lanes (a ragged warp and block), one chunk, and a segment long
    # enough for 64-bit keys (a lean chunk of 8704 bytes has S = n_pad)
    dp_sets["B=3, n_pad=1280, S=256"] = (
        cdp.random_inputs(dev, B=3, n_pad=1280, seed=4), 256)
    dp_sets["B=1, S=1024"] = (cdp.random_inputs(dev, B=1, seed=5), 1024)
    dp_sets["B=2, S=8704"] = (cdp.random_inputs(dev, B=2, n_pad=8704, seed=6),
                              8704)
    # the CPU tests' crafted sets (experiments/crafted_dp.py)
    for name, (arrays, lc) in cdp.dp_sets().items():
        dp_sets[f"crafted: {name}"] = (
            tuple(torch.as_tensor(a, device=dev) for a in arrays)
            + (torch.as_tensor(lc, device=dev),), cdp.DP_S)
    for name, (args, S) in dp_sets.items():
        for ladder in (pk.LEN_LADDER_DENSE2, pk.LEN_LADDER):
            err_dp = max(err_dp, require_equal(
                f"dp_parse ({name}, {len(ladder)} rungs)",
                pk.dp_parse(*args, S, ladder),
                pk.dp_parse_plain(*args, S, ladder)))
    bp0, real_dp, real_pack = main_path_kernel_inputs(batches[0], lengths)
    err_dp = max(err_dp, require_equal(
        "dp_parse (main path)", pk.dp_parse(*real_dp, po.DP_SEG),
        pk.dp_parse_plain(*real_dp, po.DP_SEG)))
    print(f"K1 dp_parse: equal to its plain version (random, main path; "
          f"at both ladders {', '.join(dp_sets)})", flush=True)

    # ---- K2: the pack kernel against its plain version -----------------
    # the main path's inputs of the rand and runs parts of the corpus
    # (experiments/corpus.py: rand 6u-7u, runs 7u-8u, u an eighth), the
    # runs part's groups a few bits each; and crafted start words
    u = nchunks // 8
    nw1 = pd.dyn_nwords(CHUNK)
    rng = np.random.default_rng(5)
    pack_sets = {
        "random": pack_random_inputs(dev),
        "main path": real_pack,
        "main path, rand class": main_path_kernel_inputs(
            torch.as_tensor(chunks[6 * u:7 * u].copy(), device=dev),
            lengths[:u])[2],
        "main path, runs class": main_path_kernel_inputs(
            torch.as_tensor(chunks[7 * u:8 * u].copy(), device=dev),
            lengths[:u])[2],
        "main path, B = 1": main_path_kernel_inputs(batches[0][:1],
                                                    lengths[:1])[2],
        **{f"main path, {name}": main_path_kernel_inputs(
            torch.as_tensor(arr, device=dev), lengths)[2]
           for name, arr in dense_then_sparse_chunks(chunks).items()},
        "one start word per chunk": crafted_pack_inputs(
            np.array([[1000] * 8192, [0] * 8192]), nw1, pd.DYN_CAPW + 1,
            dev, 6),
        "start words within 46 of nwords": crafted_pack_inputs(
            np.sort(rng.integers(nw1 - 46, nw1, (2, 700))), nw1,
            pd.DYN_CAPW + 1, dev, 7),
        "sparse start words": crafted_pack_inputs(
            np.sort(rng.integers(0, nw1, (2, 200))), nw1, pd.DYN_CAPW + 1,
            dev, 8),
        # the tile after 4000 groups on 100 words ORs ~1800 of their rows
        "40 groups a word, then one every 20 words": crafted_pack_inputs(
            np.tile(np.concatenate([np.arange(4000) // 40,
                                    100 + 20 * np.arange(4192)]), (2, 1)),
            nw1, pd.DYN_CAPW + 1, dev, 9),
    }
    err_pack = 0
    for name, args in pack_sets.items():
        want = pk.group_place(*args)
        err_pack = max(err_pack, require_equal(
            f"pack_groups ({name})", [pk.pack_groups(*args)], [want]))
        print(f"K2 pack_groups ({name}, sbuf {list(args[0].shape)}, up to "
              f"{max_shared_start(args[1])} groups on one start word): "
              f"equal to the plain version", flush=True)
    # the wrapper runs its kernel once and no other device op (a memset
    # or a copy would be a graph node of its own)
    # first on two torch ops whose nodes are known: a fill kernel and a
    # device-to-device copy
    a = torch.empty(4096, dtype=torch.int64, device=dev)
    b = torch.empty_like(a)
    known = sorted(graph_node_types(lambda: (a.zero_(), b.copy_(a))))
    if known != ["kernel", "memcpy"]:
        raise AssertionError(f"graph nodes of zero_ and copy_: {known}")
    before = pk.pack_groups.launches
    ops = graph_node_types(lambda: pk.pack_groups(*real_pack))
    print(f"K2 wrapper, device ops of one call (CUDA graph nodes): "
          f"{json.dumps(ops)}; zero_ and copy_ give {json.dumps(known)}",
          flush=True)
    if ops != ["kernel"] or pk.pack_groups.launches - before != 2:
        raise AssertionError("pack_groups: one call's graph is not its one "
                             "kernel launch and nothing else")
    # and the DP's wrapper likewise
    before = pk.dp_parse.launches
    ops = graph_node_types(lambda: pk.dp_parse(*real_dp, po.DP_SEG))
    print(f"K1 wrapper, device ops of one call (CUDA graph nodes): "
          f"{json.dumps(ops)}", flush=True)
    if ops != ["kernel"] or pk.dp_parse.launches - before != 2:
        raise AssertionError("dp_parse: one call's graph is not its one "
                             "kernel launch and nothing else")

    # ---- C1, C2: the loop kernels against their plain versions ---------
    scan = scan_phase(batches, lengths, bfinal, card)

    # ---- C3, C4: the chain extension against its plain versions --------
    chain_res = chain_phase(batches, lengths, bfinal, card)

    # ---- C5: the sorted matchfind's probes against its plain versions --
    probe_res = probe_phase(root, chunks, batches, lengths, bfinal, card)

    # ---- literal cost tables: CUDA against the CPU --------------------
    for b in batches:
        tab = po.literal_cost_table(b, lengths)
        tab_cpu = po.literal_cost_table(b.cpu(), lengths.cpu())
        require_equal("literal cost table", [tab.cpu()], [tab_cpu])
    print("literal cost tables: CUDA equals CPU on every batch", flush=True)

    # ---- the compress main path, through the entry point ---------------
    for mod in (pk, sk, dd, ck, qk):
        mod.reset_launch_counts()
    outs = [po.compress_chunks_lean(b, lengths, bfinal) for b in batches]
    torch.cuda.synchronize()
    best = time_best(lambda: [po.compress_chunks_lean(b, lengths, bfinal)
                              for b in batches])
    lean_stages = stage_ms(po.compress_chunks_lean, batches, lengths, bfinal)
    launches = {"dp_parse": pk.dp_parse.launches,
                "pack_groups": pk.pack_groups.launches,
                "commit_fsm": sk.commit_fsm.launches,
                "code_lens": sk.code_lens.launches,
                "chain_relax": chain_counts(ck)["chain_relax"],
                **probe_counts()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["segment_probe"] != launches["chain_relax"]:
        raise AssertionError(f"the lean path: C5 launched "
                             f"{launches['segment_probe']} times in "
                             f"{launches['chain_relax']} calls")
    if dd.decompress_chunks_words.launches or \
            chain_counts(ck)["chain_double"]:
        raise AssertionError("the lean path launched the decoder or C4")

    comp_bytes = 0
    for bi, (words, total_bits) in enumerate(outs):
        words, total_bits = words.cpu(), total_bits.cpu()
        for k in range(BATCH):
            stream = pp.device_stream_to_bytes(words[k], total_bits[k])
            if zlib.decompressobj(-15).decompress(stream) != \
                    chunks[bi * BATCH + k].tobytes():
                raise AssertionError(f"chunk {bi * BATCH + k} does not "
                                     f"round-trip through zlib")
            comp_bytes += len(stream)
    print(f"main path: {len(corpus) / best / 1e9:.6f} GB/s (best of 3 "
          f"passes over {len(corpus)} bytes, {best:.6f} s), ratio "
          f"{comp_bytes / len(corpus):.6f}, every chunk round-trips",
          flush=True)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    print("stage ms per 16 MiB pass (CUDA events): "
          + json.dumps({k: round(v, 3) for k, v in lean_stages.items()}),
          flush=True)

    # ---- the CPU against the card on one chunk -------------------------
    w_cpu, t_cpu = po.compress_chunks_lean(chunks[:1], np.array([CHUNK]),
                                           np.array([True]), device="cpu")
    w_gpu, t_gpu = outs[0]
    require_equal("CPU vs CUDA stream", [w_cpu[0], t_cpu[0]],
                  [w_gpu[0].cpu(), t_gpu[0].cpu()])
    # and a short tail chunk: 40 000 bytes of a 64 KiB buffer
    tail = (chunks[0, :1 << 16][None].copy(), np.array([40000]),
            np.array([True]))
    require_equal("CPU vs CUDA stream (tail chunk)",
                  po.compress_chunks_lean(*tail, device="cpu"),
                  [x.cpu() for x in po.compress_chunks_lean(*tail)])
    print("CPU agreement: chunk 0 and a 40000-byte tail chunk give the same "
          "words on the CPU", flush=True)

    # ---- the greedy/lazy tiers: static, dyn1, dyn2, dyn3 --------------
    # every chunk through zlib and equal to the JAX package's total_bits
    # (pinned by tests/pin_greedy_total_bits.py), one pack launch a call
    # and no DP, CUDA equal to the CPU on chunk 0 and the tail chunk, K2
    # equal to group_place on each tier's own inputs, and the dyn1 and
    # static streams back through K3
    pinned = json.loads((root / GREEDY_BITS).read_text())["total_bits"]
    tiers = {"static": pp.compress_chunks_static,
             "dyn1": pd.compress_chunks_dynamic,
             "dyn2": pd.compress_chunks_dynamic2,
             "dyn3": pd.compress_chunks_dynamic3}
    pad_w = 2 * dd.STAGE_W
    full = torch.full((nchunks,), CHUNK, dtype=torch.int32, device=dev)
    corpus_d = torch.as_tensor(chunks.copy(), device=dev)
    greedy = {}
    for name, entry in tiers.items():
        for mod in (pk, sk, dd, ck, qk):
            mod.reset_launch_counts()
        outs_t = [entry(b, lengths, bfinal) for b in batches]
        torch.cuda.synchronize()
        t_launch = {"pack_groups": pk.pack_groups.launches,
                    "dp_parse": pk.dp_parse.launches,
                    "commit_fsm": sk.commit_fsm.launches,
                    "code_lens": sk.code_lens.launches,
                    "chain_relax": ck.chain_extend_multi.launches,
                    "chain_extend": ck.chain_extend.launches,
                    "chain_extend2": ck.chain_extend2.launches,
                    **probe_counts()}
        # C4 once a call (dyn2 and dyn3: the A/B doubling, and the
        # one-candidate one of the rescue pass); C5 once a call (static
        # and dyn1: the main pass; dyn2 and dyn3: the rescue pass)
        two = name in ("dyn2", "dyn3")
        want = {"pack_groups": len(batches), "dp_parse": 0,
                "commit_fsm": len(batches),
                "code_lens": 0 if name == "static" else len(batches),
                "chain_relax": 0, "chain_extend": len(batches),
                "chain_extend2": len(batches) if two else 0,
                "segment_probe": len(batches)}
        if t_launch != want or dd.decompress_chunks_words.launches:
            raise AssertionError(f"{name}: launches {t_launch}, not {want}")
        words_t = torch.cat([w for w, _ in outs_t])
        bits_t = torch.cat([t for _, t in outs_t])
        if bits_t.tolist() != pinned[name]:
            raise AssertionError(f"{name}: total_bits {bits_t.tolist()} "
                                 f"differ from the JAX package's "
                                 f"{pinned[name]}")
        w_cpu_all = words_t.cpu()
        for k in range(nchunks):
            stream = pp.device_stream_to_bytes(w_cpu_all[k], bits_t[k])
            if zlib.decompress(stream, -15) != chunks[k].tobytes():
                raise AssertionError(f"{name}: chunk {k} does not inflate "
                                     f"to its input")
        best_t = time_best(lambda: [entry(b, lengths, bfinal)
                                    for b in batches])
        stages = stage_ms(entry, batches, lengths, bfinal)
        ratio = int(((bits_t + 7) // 8).sum()) / len(corpus)
        for args in ((chunks[:1], np.array([CHUNK]), np.array([True])),
                     tail):
            require_equal(f"{name}: CPU vs CUDA stream",
                          entry(*args, device="cpu"),
                          [x.cpu() for x in entry(*args)])
        greedy[name] = {"gb_s": len(corpus) / best_t / 1e9, "s": best_t,
                        "ratio": ratio, "launches": t_launch,
                        "stage_ms": stages, "words": words_t,
                        "total_bits": bits_t}
        print(f"{name}: {len(corpus) / best_t / 1e9:.6f} GB/s (best of 3 "
              f"passes over {len(corpus)} bytes, {best_t:.6f} s), ratio "
              f"{ratio:.6f}; all 16 total_bits equal the JAX package's, "
              f"every chunk inflates through zlib, CUDA equals CPU on "
              f"chunk 0 and the tail chunk; launches {json.dumps(t_launch)} "
              f"for {len(batches)} calls; stage ms per 16 MiB pass (CUDA "
              f"events) "
              f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
              f"{card}", flush=True)
    # K2 on each tier's own inputs: the text batch and the rand + runs one
    pack_tiers = {}
    for name in tiers:
        for bi in (0, len(batches) - 1):
            args = greedy_pack_inputs(name, batches[bi], lengths)
            err_pack = max(err_pack, require_equal(
                f"pack_groups ({name}, batch {bi})",
                [pk.pack_groups(*args)], [pk.group_place(*args)]))
            if bi == 0:
                pack_tiers[name] = args
        sbuf_t, gw_t, nw_t = pack_tiers[name]
        print(f"K2 pack_groups ({name}, sbuf {list(sbuf_t.shape)}, up to "
              f"{max_shared_start(args[1])} groups on one start word in the "
              f"rand + runs batch): equal to the plain version on the text "
              f"and the rand + runs batches", flush=True)
    # K3 decodes the dyn1 and static streams back to the corpus
    for name in ("dyn1", "static"):
        w = greedy[name]["words"]
        w = torch.cat([w, torch.zeros(nchunks, pad_w, dtype=w.dtype,
                                      device=dev)], 1)
        clen = ((greedy[name]["total_bits"] + 7) // 8).to(torch.int32)
        out, st, ol, cons = dd.decompress_chunks_words(w, clen, full, CHUNK)
        if not (bool((st == 0).all()) and bool((ol == CHUNK).all())
                and bool((cons == clen).all()) and torch.equal(out, corpus_d)):
            raise AssertionError(f"K3 does not decode the {name} streams "
                                 f"back to the corpus")
    print("K3 decode_chunks: the 16 dyn1 and the 16 static streams decode to "
          "the corpus, status 0", flush=True)

    # ---- the DP tiers: optfast, optimal, optimal2, deep, levels 5-12 ----
    # every chunk through zlib and equal to the JAX package's total_bits
    # (pinned by tests/pin_dp_total_bits.py), K1 launched once a cost pass
    # and K2 once a call, CUDA equal to the CPU on chunk 0 and the tail
    # chunk (optfast, deep), K1 equal to its plain version at both ladders
    # on each tier's own inputs of every pass (the refined passes' tables
    # one a chunk), K2 on optfast's, and the optfast streams back through
    # K3
    dp_pinned = json.loads((root / DP_BITS).read_text())["total_bits"]
    dp_entries = {"optfast": po.compress_chunks_optfast,
                  "optimal": po.compress_chunks_optimal,
                  "optimal2": po.compress_chunks_optimal2,
                  "deep": po.compress_chunks_optimal_deep}
    dp_passes = {name: po.TIERS[name]["passes"] for name in dp_entries}
    for k, kw in po.MESH_LEVEL_OPTIONS.items():
        dp_entries[f"level{k}"] = functools.partial(
            po.compress_chunks_optimal_with, **kw)
        dp_passes[f"level{k}"] = kw["passes"]
    dp_tiers = {}
    for name, entry in dp_entries.items():
        for mod in (pk, sk, dd, ck, qk):
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        outs_t = [entry(b, lengths, bfinal) for b in batches]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t_launch = {"dp_parse": pk.dp_parse.launches,
                    "pack_groups": pk.pack_groups.launches,
                    "commit_fsm": sk.commit_fsm.launches,
                    "code_lens": sk.code_lens.launches,
                    **chain_counts(ck), **probe_counts()}
        # a commit a cost pass; a code-length build a further pass and
        # one for the emission; C3 once a call, C4 once a call with the
        # rescue pass (deep, levels 10-12); C5 once a call of the lean
        # candidates (optfast, levels 5-7) or the rescue pass
        rescue = name in ("deep", "level10")
        lean_form = name in ("optfast", "level5")
        want = {"dp_parse": dp_passes[name] * len(batches),
                "pack_groups": len(batches),
                "commit_fsm": dp_passes[name] * len(batches),
                "code_lens": dp_passes[name] * len(batches),
                "chain_relax": len(batches),
                "chain_double": len(batches) if rescue else 0,
                "segment_probe": len(batches) if rescue or lean_form
                else 0}
        if t_launch != want or dd.decompress_chunks_words.launches:
            raise AssertionError(f"{name}: launches {t_launch}, not {want}")
        words_t = torch.cat([w for w, _ in outs_t])
        bits_t = torch.cat([t for _, t in outs_t])
        if bits_t.tolist() != dp_pinned[name]:
            raise AssertionError(f"{name}: total_bits {bits_t.tolist()} "
                                 f"differ from the JAX package's "
                                 f"{dp_pinned[name]}")
        w_cpu_all = words_t.cpu()
        for k in range(nchunks):
            stream = pp.device_stream_to_bytes(w_cpu_all[k], bits_t[k])
            if zlib.decompress(stream, -15) != chunks[k].tobytes():
                raise AssertionError(f"{name}: chunk {k} does not inflate "
                                     f"to its input")
        ratio = int(((bits_t + 7) // 8).sum()) / len(corpus)
        row = {"passes": dp_passes[name], "ratio": ratio,
               "launches": t_launch, "first_pass_s": first_s,
               "words": words_t, "total_bits": bits_t}
        if name == "optfast":
            # best of 3 passes, then one pass by stage
            row["s"] = time_best(lambda: [entry(b, lengths, bfinal)
                                          for b in batches])
            row["stage_ms"] = stage_ms(entry, batches, lengths, bfinal)
        elif name in ("optimal", "optimal2", "deep"):
            # the checked pass was the warm-up; one timed pass by stage
            t0 = time.perf_counter()
            row["stage_ms"] = stage_ms(entry, batches, lengths, bfinal)
            row["s"] = time.perf_counter() - t0
        if name in ("optfast", "deep"):
            for args in ((chunks[:1], np.array([CHUNK]), np.array([True])),
                         tail):
                require_equal(f"{name}: CPU vs CUDA stream",
                              entry(*args, device="cpu"),
                              [x.cpu() for x in entry(*args)])
        dp_tiers[name] = row
        timing = ("" if "s" not in row else
                  f"{len(corpus) / row['s'] / 1e9:.6f} GB/s ("
                  + ("best of 3 passes" if name == "optfast" else
                     "one pass after a warm-up")
                  + f" over {len(corpus)} bytes, {row['s']:.6f} s), ")
        print(f"{name}: {timing}ratio {ratio:.6f}; all 16 total_bits equal "
              f"the JAX package's, every chunk inflates through zlib"
              + (", CUDA equals CPU on chunk 0 and the tail chunk"
                 if name in ("optfast", "deep") else "")
              + f"; launches {json.dumps(t_launch)} for {len(batches)} "
              f"calls; first pass {first_s:.6f} s"
              + (f"; stage ms per 16 MiB pass (CUDA events) "
                 f"{json.dumps({k: round(v, 3) for k, v in row['stage_ms'].items()})}"
                 if "stage_ms" in row else "") + f"; {card}", flush=True)
    # K1 at both ladders on each tier's own inputs, every pass; K2 on
    # optfast's
    dp_calls = {}
    for name in ("optfast", "optimal", "optimal2", "deep"):
        (_, packs), dps = record_calls(
            pk, "dp_parse", lambda: record_calls(
                pk, "pack_groups",
                lambda: dp_entries[name](batches[0], lengths, bfinal)))
        dp_calls[name] = dps
        for i, args in enumerate(dps):
            for ladder in (pk.LEN_LADDER, pk.LEN_LADDER_DENSE2):
                err_dp = max(err_dp, require_equal(
                    f"dp_parse ({name}, pass {i + 1}, "
                    f"{len(ladder)} rungs)", pk.dp_parse(*args[:14], ladder),
                    pk.dp_parse_plain(*args[:14], ladder)))
        if name == "optfast":
            sbuf_o, gw_o, nw_o = packs[0]
            err_pack = max(err_pack, require_equal(
                "pack_groups (optfast)", [pk.pack_groups(*packs[0])],
                [pk.group_place(*packs[0])]))
    print(f"K1 dp_parse: equal to its plain version at LEN_LADDER and "
          f"LEN_LADDER_DENSE2 on every pass's inputs of optfast, optimal, "
          f"optimal2 and deep (lc [4, 259] in the refined passes); K2 "
          f"equal to group_place on optfast's (sbuf {list(sbuf_o.shape)})",
          flush=True)
    # K3 decodes the optfast streams back to the corpus
    w = dp_tiers["optfast"]["words"]
    w = torch.cat([w, torch.zeros(nchunks, pad_w, dtype=w.dtype,
                                  device=dev)], 1)
    clen = ((dp_tiers["optfast"]["total_bits"] + 7) // 8).to(torch.int32)
    out, st, ol, cons = dd.decompress_chunks_words(w, clen, full, CHUNK)
    if not (bool((st == 0).all()) and bool((ol == CHUNK).all())
            and bool((cons == clen).all()) and torch.equal(out, corpus_d)):
        raise AssertionError("K3 does not decode the optfast streams back "
                             "to the corpus")
    print("K3 decode_chunks: the 16 optfast streams decode to the corpus, "
          "status 0", flush=True)

    # ---- the compress options only scripts/ reaches ---------------------
    opt = options_phase(root, corpus, chunks, batches, lengths, card)
    err_dp = max(err_dp, opt["err_dp"])
    err_pack = max(err_pack, opt["err_pack"])

    # ---- K3: the decoder against its plain version ---------------------
    zstreams = [zlib6(chunks[i].tobytes()) for i in range(nchunks)]
    z_comp, z_clen = dd.pack_streams(zstreams, pad_w)
    z_words = torch.as_tensor(z_comp.view(np.int32), device=dev)
    z_clen_d = torch.as_tensor(z_clen, device=dev)
    lean = [pp.device_stream_to_bytes(outs[i // BATCH][0][i % BATCH],
                                      outs[i // BATCH][1][i % BATCH])
            for i in PART_CHUNKS]
    fixed = [zlib6(chunks[0].tobytes(), zlib.Z_FIXED)]
    damaged = damaged_streams(chunks)
    # (name, comp, comp_len, out_len, known_size, out_bytes)
    sets = [("zlib-6, 16 chunks", z_comp, z_clen, [CHUNK] * nchunks, True,
             CHUNK),
            ("lean, one chunk per part", *dd.pack_streams(lean, pad_w),
             [CHUNK] * len(lean), True, CHUNK),
            ("Z_FIXED", *dd.pack_streams(fixed, pad_w), [CHUNK], True, CHUNK)]
    d_comp, d_clen = dd.pack_streams(damaged, pad_w)
    run_on = [cs.run_on_stream(bits, n) for bits in (1, 3)
              for n in (1, 106, 113, 4000)]
    r_comp, r_clen = dd.pack_streams(run_on, pad_w)
    for known in (True, False):
        sets.append((f"damaged, known_size={known}", d_comp, d_clen,
                     [DAMAGED_CHUNK] * len(damaged), known, DAMAGED_CHUNK))
        sets.append((f"run-on, known_size={known}", r_comp, r_clen,
                     [70001, 69632, 81920, 66000] * 2, known, 81920))
    # K3's crafted sets, the CPU tests' B = 4 x 12288-word batches; in
    # unknown-size mode 4 bytes wider a row, so that rows 1-3 start off a
    # 16-byte boundary and the window's flush takes its 4-byte stores
    for name, (streams, out_lens, caps) in cs.decode_sets(
            cs.repo_text(root)).items():
        for known, lens, width in ((True, out_lens, cs.DEC_OUT_BYTES),
                                   (False, caps, cs.DEC_OUT_BYTES + 4)):
            comp, clen, olen = cs.pack_rows(streams, lens, rows=cs.DEC_B)
            sets.append((f"crafted K3: {name}, known_size={known}", comp,
                         clen, olen.tolist(), known, width))
    err_dec = 0
    plain_s = {}
    for name, comp, clen, olen, known, out_bytes in sets:
        args = (comp.view(np.int32), clen, np.array(olen, np.int32),
                out_bytes)
        got = dd.decompress_chunks_words(*args, known_size=known)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = dd.decompress_chunks_words(*args, known_size=known,
                                          device="cpu")
        plain_s[name] = time.perf_counter() - t0
        err_dec = max(err_dec, require_equal(f"decode_chunks ({name})",
                                             [g.cpu() for g in got], want))
        n_bad = int(want[1].sum())
        print(f"K3 decode_chunks ({name}): equal to its plain version, "
              f"{len(olen) - n_bad} chunks OK and {n_bad} BAD_DATA, plain "
              f"{plain_s[name]:.3f} s", flush=True)
    print(f"K3 plain version: {sum(plain_s.values()):.3f} s in all",
          flush=True)

    # ---- the decode main path, through the entry points ----------------
    rt_words = torch.cat([o[0] for o in outs])
    rt_words = torch.cat([rt_words, torch.zeros(
        rt_words.shape[0], pad_w, dtype=torch.int32, device=dev)], 1)
    rt_clen = ((torch.cat([o[1] for o in outs]) + 7) // 8).to(torch.int32)
    pk.reset_launch_counts()
    dd.reset_launch_counts()
    dec_rate = {}
    for name, words, clen in (("round trip", rt_words, rt_clen),
                              ("zlib-6", z_words, z_clen_d)):
        out, st, ol, cons = dd.decompress_chunks_words(words, clen, full,
                                                       CHUNK)
        if not (bool((st == 0).all()) and bool((ol == CHUNK).all())
                and bool((cons == clen).all())
                and torch.equal(out, corpus_d)):
            raise AssertionError(f"decode ({name}): a chunk does not "
                                 f"decode to the corpus")
        best = time_best(lambda: dd.decompress_chunks_words(
            words, clen, full, CHUNK))
        dec_rate[name] = (len(corpus) / best / 1e9, best)
    n_max = max(map(len, zstreams))
    bufs = np.zeros((nchunks, n_max), np.uint8)
    for k, zs in enumerate(zstreams):
        bufs[k, :len(zs)] = np.frombuffer(zs, np.uint8)
    out, ol, cons, st = dd.decompress_chunks(bufs, z_clen, CHUNK)
    if not (bool((st == 0).all()) and bool((ol == CHUNK).all())
            and torch.equal(cons.cpu(), torch.as_tensor(z_clen))
            and torch.equal(out, corpus_d)):
        raise AssertionError("unknown-size decompress_chunks: wrong result")
    dec_launches = dd.decompress_chunks_words.launches
    if dec_launches <= 0:
        raise AssertionError("the decode path never launched decode_chunks")
    if pk.dp_parse.launches or pk.pack_groups.launches:
        raise AssertionError("the decode path launched a compress kernel")
    for name, (gbs, best) in dec_rate.items():
        print(f"decode main path ({name}): {gbs:.6f} GB/s of output (best "
              f"of 3 passes over {nchunks} x {CHUNK} bytes in one call, "
              f"{best:.6f} s), every chunk equals the corpus", flush=True)
    print(f"unknown-size decompress_chunks (zlib-6): out_lens {CHUNK}, "
          f"consumed = stream lengths ({int(z_clen.sum())} bytes), every "
          f"chunk equals the corpus", flush=True)
    print(f"decode main path launches: "
          f"{json.dumps({'decode_chunks': dec_launches})}", flush=True)

    # ---- the whole-file codec, through its entry points ----------------
    t0 = time.perf_counter()
    file_launches = whole_file_phase(
        root, corpus, chunks, bufs, z_clen,
        {**pinned, **dp_pinned}, card)
    print(f"whole-file phase: {time.perf_counter() - t0:.3f} s", flush=True)
    err_dp = max(err_dp, file_launches["max_abs_err"]["dp_parse"])
    err_pack = max(err_pack, file_launches["max_abs_err"]["pack_groups"])

    # ---- the mesh with its shards at once, and every wrapper on a side
    # stream from a worker thread
    t0 = time.perf_counter()
    mesh_res = mesh_phase(root, corpus, chunks, bufs, z_clen,
                          {**pinned, **dp_pinned}, card)
    print(f"mesh phase: {time.perf_counter() - t0:.3f} s", flush=True)
    err_dp = max(err_dp, mesh_res["max_abs_err"]["dp_parse"])
    err_pack = max(err_pack, mesh_res["max_abs_err"]["pack_groups"])

    # ---- the libdeflate contract on the host engine, crossed with K1-K3
    host = host_contract_phase(root, corpus, chunks, card)
    err_dec = max(err_dec, host["max_abs_err"])

    # ---- the FSM decoder (F1), the programs and a device trace ---------
    fsm_res = fsm_phase(root, corpus, chunks, bufs, z_clen,
                        rt_words.view(torch.uint8), rt_clen, dec_rate,
                        batches[0], lengths, bfinal, card, against)

    # ---- the randomized harnesses: soak and fuzz ------------------------
    soak_fuzz = soak_fuzz_phase(root, card)
    err_dp = max(err_dp, soak_fuzz["max_abs_err"]["dp_parse"])
    err_pack = max(err_pack, soak_fuzz["max_abs_err"]["pack_groups"])

    # ---- the measurement and ratio drivers of scripts/ -----------------
    drivers = drivers_phase(root, corpus, card)
    err_dp = max(err_dp, drivers["max_abs_err"]["dp_parse"])
    err_pack = max(err_pack, drivers["max_abs_err"]["pack_groups"])

    # ---- K4: the tokenize-only kernel against its plain version --------
    err_tok = 0
    tok_plain_s = {}
    tok_sets = [(name, comp, clen, olen) for name, comp, clen, olen, known, _
                in sets if known and not name.startswith(("lean", "crafted"))]
    tok_sets += [(f"crafted: {name}", *rows) for name, rows in
                 cs.crafted_sets(cs.repo_text(root)).items()]
    for name, comp, clen, olen in tok_sets:
        args = (comp.view(np.int32), clen, np.array(olen, np.int32))
        t0 = time.perf_counter()
        want = tk.tokenize_chunks(*args, device="cpu")
        tok_plain_s[name] = time.perf_counter() - t0
        for cfg, (unroll, store) in tk.CONFIGS.items():
            got = tk.tokenize_chunks(*args, unroll, store)
            err_tok = max(err_tok, require_equal(
                f"tokenize_chunks {cfg} ({name})", [g.cpu() for g in got],
                want))
        n_bad = int(want[0].sum())
        print(f"K4 tokenize_chunks ({name}): all {len(tk.CONFIGS)} "
              f"configurations equal to the plain version, "
              f"{len(olen) - n_bad} chunks OK and {n_bad} BAD_DATA, plain "
              f"{tok_plain_s[name]:.3f} s", flush=True)
    sts = tk.sass_store_counts()
    if not (sts["tokst"] > sts["tok1"] and sts["tokst4"] > sts["tok4"]):
        raise AssertionError(f"a token-store variant lost its stores: {sts}")
    print(f"K4 SASS shared-memory stores (STS) per variant: "
          f"{json.dumps(sts)}", flush=True)
    # the chain's floor: the table lookups of the chunk with the most
    # tokens, each waiting one dependent shared-memory load
    chain = tk.chain_counts(z_comp.view(np.int32), z_clen,
                            np.full(nchunks, CHUNK, np.int32))
    top = int(chain[0].argmax())
    lat = tk.shared_load_latency()
    chain_floor_ms = int(chain[1, top]) * lat["ns"] / 1e6
    cyc = tk.phase_cycles(z_words, z_clen_d, full).cpu().numpy()
    loop_cyc = cyc[:, 0] - cyc[:, 1]
    print(f"K4 chain (zlib-6, 16 chunks): chunk {top} has the most tokens, "
          f"{int(chain[0, top])}, and {int(chain[1, top])} table lookups; "
          f"a dependent shared-memory load takes {lat['cycles']:.3f} cycles, "
          f"{lat['ns']:.4f} ns: chain floor {chain_floor_ms:.6f} ms",
          flush=True)
    print(f"K4 clock64() cycles per chunk (tok1): in all "
          f"{cyc[:, 0].tolist()}, table setups {cyc[:, 1].tolist()}; chunk "
          f"{top}: {loop_cyc[top] / chain[1, top]:.3f} cycles per lookup in "
          f"the token loop, table setups "
          f"{cyc[top, 1] / cyc[top, 0]:.6f} of its cycles", flush=True)
    # K3's chain under its own loop: its burst budget stops short of each
    # 32 KiB boundary, and only a match looks up an offset
    chain3 = dd.chain_counts(z_comp.view(np.int32), z_clen,
                             np.full(nchunks, CHUNK, np.int32))
    top3 = int(chain3[0].argmax())
    chain3_floor_ms = int(chain3[1, top3]) * lat["ns"] / 1e6
    print(f"K3 chain (zlib-6, 16 chunks): chunk {top3} has the most tokens, "
          f"{int(chain3[0, top3])}, and {int(chain3[1, top3])} table lookups "
          f"under K3's loop: chain floor {chain3_floor_ms:.6f} ms at "
          f"{lat['ns']:.4f} ns a lookup", flush=True)

    # ---- K5-K7: the launch probes against their plain versions ---------
    gen = torch.Generator(device=dev).manual_seed(3)
    err_probe = {"grid_add_one": 0, "loop_add_one": 0, "grid_copy": 0}
    for n in lo.STEP_COUNTS:
        x = torch.randint(-1 << 31, (1 << 31) - 1, (n * lo.ROWS, lo.LANES),
                          dtype=torch.int32, device=dev, generator=gen)
        err_probe["grid_add_one"] = max(err_probe["grid_add_one"],
                                        require_equal(
            f"grid_add_one ({n} steps)", [lo.grid_add_one(x)],
            [lo.add_one_plain(x)]))
    # K6's persistent wave of one block per SM: fewer tiles than SMs, a
    # ragged last pass, and both ends of int32 (2**31 - 1 wraps)
    for ntiles in LOOP_TILE_COUNTS:
        x = torch.randint(-1 << 31, (1 << 31) - 1,
                          (ntiles * lo.ROWS, lo.LANES), dtype=torch.int32,
                          device=dev, generator=gen)
        x.view(-1)[::97] = (1 << 31) - 1
        x.view(-1)[1::101] = -1 << 31
        err_probe["loop_add_one"] = max(err_probe["loop_add_one"],
                                        require_equal(
            f"loop_add_one ({ntiles} tiles)", [lo.loop_add_one(x)],
            [lo.add_one_plain(x)]))
        if ntiles == lo.LOOP_TILES:
            x_loop = x
    x_tile = torch.randn(rd.TILE, device=dev, generator=gen)
    for steps in rd.PROBE_STEPS:
        err_probe["grid_copy"] = max(err_probe["grid_copy"], require_equal(
            f"grid_copy ({steps} steps)", [rd.grid_copy(x_tile, steps)],
            [rd.copy_plain(x_tile)]))
    # K7's edges: tails of 1-3 floats, a view one float (4 bytes) into its
    # buffer, more blocks than 16-byte pieces
    copy_buf = torch.randn((1 << 20) + 1, device=dev, generator=gen)
    for n, steps, off in ([(n, steps, off) for n in COPY_SIZES
                           for steps in rd.PROBE_STEPS for off in (0, 1)]
                          + [(3, 64, 0), (4097, 2000, 1), (16384, 5000, 0),
                             (16384, 5000, 1)]):
        x = copy_buf[off:off + n]
        err_probe["grid_copy"] = max(err_probe["grid_copy"], require_equal(
            f"grid_copy ({n} floats, {steps} steps, offset {off})",
            [rd.grid_copy(x, steps)], [rd.copy_plain(x)]))
    print(f"K5 grid_add_one, K6 loop_add_one, K7 grid_copy: equal to x + 1 "
          f"and x.clone() at {lo.STEP_COUNTS} steps, {LOOP_TILE_COUNTS} tiles "
          f"and {rd.PROBE_STEPS} steps; K7 also at {COPY_SIZES} floats, "
          f"offsets 0 and 1 float, and 2000-5000 blocks", flush=True)
    # K5 beside the launch floor: an empty kernel on K5's grid (one block
    # of 1024 threads a tile, 256 tiles), K5 and x + 1 on K5's input, each
    # 200 launches replayed from a CUDA graph, in turns
    floor_lib = build_tagged({"floor": ("launch_floor",
                                        LAUNCH_FLOOR_CU)})[0]["floor"]
    empty = floor_lib.empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int
    per_element = floor_lib.add_one_elem_launch
    per_element.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    per_element.restype = ctypes.c_int
    x5 = torch.zeros(lo.STEP_COUNTS[-1] * lo.ROWS, lo.LANES,
                     dtype=torch.int32, device=dev)

    def k5_per_element():
        out = torch.empty_like(x5)
        with _build.launch_context((x5, out),
                                   "K5, per-element design") as stream:
            rc = per_element(x5.data_ptr(), out.data_ptr(),
                             lo.STEP_COUNTS[-1], lo.ROWS, stream)
        if rc:
            raise RuntimeError(f"K5, per-element design: CUDA error {rc}")
        return out

    if not torch.equal(k5_per_element(), x5 + 1):
        raise AssertionError("K5's per-element design is not x + 1")

    def launch_floor(threads):
        with _build.launch_context((x5,), "empty kernel") as stream:
            rc = empty(lo.STEP_COUNTS[-1], threads, stream)
        if rc:
            raise RuntimeError(f"empty kernel: CUDA error {rc}")

    # the floor on K5's grid (a thread per 16 bytes of a tile) and on the
    # per-element design's (a thread per element)
    probes = {"empty kernel": lambda: launch_floor(lo.ROWS * lo.LANES // 4),
              "empty kernel, 1024 threads a block": lambda: launch_floor(
                  min(lo.ROWS * lo.LANES, 1024)),
              "K5": lambda: lo.grid_add_one(x5), "x + 1": lambda: x5 + 1,
              "K5, per-element design": k5_per_element,
              "K6's kernel on K5's input": lambda: lo.loop_add_one(x5)}
    floor_turns = {name: [] for name in probes}
    for turn in range(FLOOR_TURNS):
        for name in (list(probes) if turn % 2 == 0 else list(probes)[::-1]):
            floor_turns[name].append(graph_ms(probes[name], 200))
    floor = {name: {"ms": sum(t) / len(t), "turns": t}
             for name, t in floor_turns.items()}
    floor["K5 within the spread of x + 1"] = (
        min(floor_turns["x + 1"]) <= floor["K5"]["ms"]
        <= max(floor_turns["x + 1"]))
    print(f"K5 beside the launch floor ({lo.STEP_COUNTS[-1]} blocks of "
          f"{lo.ROWS * lo.LANES // 4} threads), its per-element design, "
          f"K6's kernel and x + 1 (graph replay, in turns): "
          f"{json.dumps(floor)}; "
          f"{card}", flush=True)

    # ---- the measurement main path, through its entry point ------------
    for mod in (pk, dd, tk, lo, rd):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = rd.main()
    if not rd.all_ok(res):
        raise AssertionError("measurement roundup: a result is wrong")
    meas_launches = {"dp_parse": pk.dp_parse.launches,
                     "pack_groups": pk.pack_groups.launches,
                     "decode_chunks": dd.decompress_chunks_words.launches,
                     "tokenize_chunks": tk.tokenize_chunks.launches,
                     "grid_add_one": lo.grid_add_one.launches,
                     "loop_add_one": lo.loop_add_one.launches,
                     "grid_copy": rd.grid_copy.launches}
    for name, count in meas_launches.items():
        if count <= 0:
            raise AssertionError(f"the measurement path never launched "
                                 f"{name}")
    print(f"measurement main path: every section right, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(f"measurement main path launches: {json.dumps(meas_launches)}",
          flush=True)
    tok = res["tok"]
    for cls, row in tok.items():
        share = row["tok1"]["s"] / row["dec"]["s"]
        print(f"ceiling {cls}: tok1 / K3 decode time = {share:.6f}",
              flush=True)

    # ---- kernel times at main-path shapes ------------------------------
    lanes = BATCH * CHUNK // po.DP_SEG
    dp_ops = (feasible_rungs(pk.LEN_LADDER_DENSE2, po.DP_SEG) * lanes
              * DP_OPS_PER_RUNG)
    # the int64 interface: twelve inputs and lc read once, span and dist
    # written once
    dp_bytes = (sum(a.numel() * a.element_size() for a in real_dp)
                + 2 * 8 * BATCH * CHUNK)
    dp_span = torch.empty(BATCH, CHUNK, dtype=torch.int64, device=dev)
    dp_dist = torch.empty_like(dp_span)
    # K1 at both ladders on the optimal tier's own inputs (pass 1 of the
    # text batch; LEN_LADDER is its ladder), beside each ladder's bounds
    opt_args = dp_calls["optimal"][0][:14]
    ladder_times = {}
    for ladder in (pk.LEN_LADDER, pk.LEN_LADDER_DENSE2):
        ops_l = (feasible_rungs(ladder, po.DP_SEG) * lanes
                 * DP_OPS_PER_RUNG)
        opt_bytes = (sum(a.numel() * a.element_size() for a in opt_args[:13])
                     + 2 * 8 * BATCH * CHUNK)
        ladder_times[f"{len(ladder)} rungs"] = {
            "inputs": "optimal, pass 1, text batch",
            "ms": cuda_ms(lambda: pk.dp_parse(*opt_args, ladder), 20),
            "kernel_ms": cuda_ms(lambda: pk.dp_parse_into(
                opt_args[:12], opt_args[12], po.DP_SEG, dp_span, dp_dist,
                ladder), 20),
            "bytes_bound_ms": 1e3 * opt_bytes / H100_BYTES_PER_S,
            "ops_bound_ms": 1e3 * ops_l / H100_INT32_OPS_PER_S}
        print(f"K1 ({len(ladder)} rungs, optimal's inputs): "
              f"{json.dumps(ladder_times[f'{len(ladder)} rungs'])}; {card}",
              flush=True)
    sbuf, gw, nwords = real_pack
    # the int64 interface: sbuf and gw read once, the output written once
    pack_bytes = 8 * (sbuf.numel() + gw.numel() + BATCH * nwords)
    pack_out = torch.empty(BATCH, nwords, dtype=torch.int64, device=dev)
    # K2 on the other main-path inputs, beside its yardstick
    for name in ("main path, rand class", "main path, runs class",
                 "main path, half dense then sparse",
                 "main path, mostly dense then sparse",
                 "40 groups a word, then one every 20 words"):
        args = pack_sets[name]
        times = {"wrapper_ms": graph_ms(lambda: pk.pack_groups(*args), 200),
                 "index_add_ms": graph_ms(index_add_call(*args), 200)}
        print(f"K2 ({name}, graph replay): {json.dumps(times)}", flush=True)
    # K2 at the greedy tiers' widths (capw + 1 = 38, 46, 62), text batch
    pack_tier_times = {}
    for name, (sb, g, nw) in pack_tiers.items():
        pack_tier_times[name] = {
            "sbuf": list(sb.shape),
            "launches": greedy[name]["launches"]["pack_groups"],
            "ms": graph_ms(lambda: pk.pack_groups(sb, g, nw), 200),
            "library_ms": graph_ms(index_add_call(sb, g, nw), 200),
            "bound_ms": 1e3 * 8 * (sb.numel() + g.numel() + BATCH * nw)
            / H100_BYTES_PER_S}
        print(f"K2 ({name}, graph replay): "
              f"{json.dumps(pack_tier_times[name])}; {card}", flush=True)
    pack_tier_times["optfast"] = {
        "sbuf": list(sbuf_o.shape),
        "launches": dp_tiers["optfast"]["launches"]["pack_groups"],
        "ms": graph_ms(lambda: pk.pack_groups(sbuf_o, gw_o, nw_o), 200),
        "library_ms": graph_ms(index_add_call(sbuf_o, gw_o, nw_o), 200),
        "bound_ms": 1e3 * 8 * (sbuf_o.numel() + gw_o.numel() + BATCH * nw_o)
        / H100_BYTES_PER_S}
    print(f"K2 (optfast, graph replay): "
          f"{json.dumps(pack_tier_times['optfast'])}; {card}", flush=True)
    kernels = [
        {"name": "dp_parse", "route": "cuda",
         "source": "libdeflate_tpu_torch/csrc/dp_parse.cu",
         "replaces": "libdeflate_tpu/compress/pallas_kernels.py:199",
         "launches": launches["dp_parse"], "max_abs_err": err_dp,
         "ms": cuda_ms(lambda: pk.dp_parse(*real_dp, po.DP_SEG), 20),
         "kernel_ms": cuda_ms(lambda: pk.dp_parse_into(
             real_dp[:12], real_dp[12], po.DP_SEG, dp_span, dp_dist), 20),
         "plain_ms": cuda_ms(lambda: pk.dp_parse_plain(*real_dp, po.DP_SEG),
                             1),
         "bound_ms": 1e3 * max(dp_bytes / H100_BYTES_PER_S,
                               dp_ops / H100_INT32_OPS_PER_S),
         "bound_by": ("operations" if dp_ops / H100_INT32_OPS_PER_S
                      > dp_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "ladders": {**ladder_times, "46 rungs": opt["ladders"]["46 rungs"]},
         "options_ladders": opt["ladders"],
         "options_launches": opt["launches"]["dp_parse"],
         "whole_file_launches": {level: n["dp_parse"] for level, n in
                                 file_launches["compress"].items()},
         "host_contract_launches": host["launches"]["dp_parse"],
         "soak_fuzz_launches": {k: v["dp_parse"] for k, v in
                                soak_fuzz["launches"].items()},
         "drivers_launches": drivers["launches"]["dp_parse"],
         "dp_tier_launches": {name: row["launches"]["dp_parse"]
                              for name, row in dp_tiers.items()}},
        {"name": "pack_groups", "route": "cuda",
         "source": "libdeflate_tpu_torch/csrc/pack_groups.cu",
         "replaces": "libdeflate_tpu/compress/pallas_kernels.py:313",
         "launches": launches["pack_groups"], "max_abs_err": err_pack,
         "ms": graph_ms(lambda: pk.pack_groups(*real_pack), 200),
         "kernel_ms": graph_ms(lambda: pk.pack_groups_into(sbuf, gw,
                                                           pack_out), 200),
         "plain_ms": graph_ms(lambda: pk.group_place(*real_pack), 200),
         "bound_ms": 1e3 * pack_bytes / H100_BYTES_PER_S,
         "bound_by": "bytes",
         "library_ms": graph_ms(index_add_call(*real_pack), 200),
         "tiers": pack_tier_times,
         "widths": opt["widths"],
         "options_launches": opt["launches"]["pack_groups"],
         "whole_file_launches": {level: n["pack_groups"] for level, n in
                                 file_launches["compress"].items()},
         "host_contract_launches": host["launches"]["pack_groups"],
         "soak_fuzz_launches": {k: v["pack_groups"] for k, v in
                                soak_fuzz["launches"].items()},
         "drivers_launches": drivers["launches"]["pack_groups"]},
        {"name": "decode_chunks", "route": "cuda",
         "source": "libdeflate_tpu_torch/csrc/decode_chunks.cu",
         "replaces": "libdeflate_tpu/decompress/pallas_decode.py:943",
         "launches": dec_launches, "max_abs_err": err_dec,
         "ms": cuda_ms(lambda: dd.decompress_chunks_words(
             z_words, z_clen_d, full, CHUNK), 3),
         "plain_ms": 1e3 * plain_s["zlib-6, 16 chunks"],
         "bound_ms": 1e3 * (int(z_clen.sum()) + nchunks * CHUNK)
         / H100_BYTES_PER_S,
         "bound_by": "bytes",
         "chain_lookups": int(chain3[1, top3]),
         "chain_floor_ms": chain3_floor_ms,
         "library_ms": None,
         "whole_file_launches": file_launches["decode_chunks"],
         "host_contract_launches": host["launches"]["decode_chunks"],
         "soak_fuzz_launches": {k: v["decode_chunks"] for k, v in
                                soak_fuzz["launches"].items()},
         "drivers_launches": drivers["launches"]["decode_chunks"]},
        {"name": "tokenize_chunks", "route": "cuda",
         "source": "libdeflate_tpu_torch/csrc/tokenize_chunks.cu",
         "replaces": "scripts/exp_tokenize_ceiling.py:351",
         "launches": meas_launches["tokenize_chunks"], "max_abs_err": err_tok,
         "ms": cuda_ms(lambda: tk.tokenize_chunks(z_words, z_clen_d, full),
                       3),
         "plain_ms": 1e3 * tok_plain_s["zlib-6, 16 chunks"],
         "bound_ms": 1e3 * (int(z_clen.sum()) + nchunks * 3 * 4)
         / H100_BYTES_PER_S,
         "bound_by": "bytes",
         "chain_lookups": int(chain[1, top]),
         "chain_floor_ms": chain_floor_ms,
         "library_ms": None},
    ]
    chain_f1 = fsm_res["chain"][:, fsm_res["top"]]
    turns = fsm_res["turns"]
    f1_build = logs.get("fsm_decode")
    kernels.append({
        "name": "fsm_decode", "route": "cuda",
        "source": "libdeflate_tpu_torch/csrc/fsm_decode.cu",
        "replaces": "libdeflate_tpu/decompress/tpu.py:168",
        "launches": fsm_res["launches"], "max_abs_err": fsm_res["max_abs_err"],
        "ms": fsm_res["ms"], "plain_ms": fsm_res["plain_ms"],
        "parent_ms": (None if turns is None else
                      sum(turns["zlib-6"]["parent"]) / 2),
        "parent_turns": turns,
        "bound_ms": 1e3 * (int(z_clen.sum()) + nchunks * CHUNK)
        / H100_BYTES_PER_S,
        "bound_by": "bytes",
        "build": None if f1_build is None else build_lines(f1_build),
        "dynamic_smem_bytes": _build.load("fsm_decode").fsm_decode_smem_bytes(),
        "chain_symbols": int(chain_f1[0]),
        "chain_lookups": int(chain_f1[1]),
        "chain_floor_ms": int(chain_f1[1]) * lat["ns"] / 1e6,
        "library_ms": None,
        "whole_file_launches": file_launches["fsm_decode"],
        "program_launches": {k: v.get("fsm_decode", 0) for k, v in
                             fsm_res["programs"].items()},
        "soak_fuzz_launches": {k: v["fsm_decode"] for k, v in
                               soak_fuzz["launches"].items()}})
    print(f"F1 chain (zlib-6, 16 chunks): chunk {fsm_res['top']} has the most "
          f"symbols, {int(chain_f1[0])}, and {int(chain_f1[1])} table "
          f"lookups: chain floor {int(chain_f1[1]) * lat['ns'] / 1e6:.6f} ms "
          f"at {lat['ns']:.4f} ns a lookup; F1 {fsm_res['ms']:.6f} ms a call",
          flush=True)
    x_grid = torch.zeros(lo.STEP_COUNTS[-1] * lo.ROWS, lo.LANES,
                         dtype=torch.int32, device=dev)
    for name, source, replaces, fn, plain, x in (
            ("grid_add_one", "launch_probes.cu",
             "scripts/exp_pallas_overhead.py:31",
             lambda x: lo.grid_add_one(x), lo.add_one_plain, x_grid),
            ("loop_add_one", "launch_probes.cu",
             "scripts/exp_pallas_overhead.py:61",
             lo.loop_add_one, lo.add_one_plain, x_loop),
            ("grid_copy", "launch_probes.cu",
             "scripts/exp_device_roundup.py:67",
             lambda x: rd.grid_copy(x, rd.PROBE_STEPS[-1]), rd.copy_plain,
             x_tile)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"libdeflate_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": meas_launches[name],
            "max_abs_err": err_probe[name],
            "ms": graph_ms(lambda: fn(x), 200),
            "plain_ms": graph_ms(lambda: plain(x), 200),
            "bound_ms": 1e3 * 2 * x.numel() * 4 / H100_BYTES_PER_S,
            "bound_by": "bytes",
            "library_ms": graph_ms(lambda: (x + 1 if name != "grid_copy"
                                            else x.clone()), 200)})
    kernels[-3]["launch_floor"] = floor
    # C1 and C2 on the lean call's inputs (C1 also at seg 512 on dyn1's,
    # C2 also at refine 16 on optfast's); the plain version is the torch
    # loop these paths ran before the kernels (the earlier kernels are
    # timed beside these by experiments/scan_variants.py --against)
    for name, source, replaces, other in (
            ("commit_fsm", "commit_fsm.cu",
             "libdeflate_tpu/compress/tpu_pipeline.py:771", "dyn1"),
            ("code_lens", "code_lens.cu",
             "libdeflate_tpu/compress/tpu_dynamic.py:140", "optfast")):
        row = scan[f"{name} lean"]
        by_bytes = row["bytes_bound_ms"] >= row["chain_bound_ms"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"libdeflate_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(scan["err"][name],
                               soak_fuzz["max_abs_err"][name],
                               drivers["max_abs_err"][name]),
            "ms": row["ms"],
            "kernel_ms": row["kernel_ms"],
            "kernel_graph_ms": row["kernel_graph_ms"],
            "plain_ms": row["plain_ms"], "plain_turns": row["plain_turns"],
            "bound_ms": max(row["bytes_bound_ms"], row["chain_bound_ms"]),
            "bound_by": "bytes" if by_bytes else "operations",
            "bytes_bound_ms": row["bytes_bound_ms"],
            "chain_steps": row["chain_steps"],
            "chain_bound_ms": row["chain_bound_ms"],
            "library_ms": None, "inputs": row["inputs"],
            other: scan[f"{name} {other}"],
            "greedy_tier_launches": {n: r["launches"][name]
                                     for n, r in greedy.items()},
            "dp_tier_launches": {n: r["launches"][name]
                                 for n, r in dp_tiers.items()},
            "options_launches": opt["launches"][name],
            "whole_file_launches": {level: n[name] for level, n in
                                    file_launches["compress"].items()},
            "soak_fuzz_launches": {k: v[name] for k, v in
                                   soak_fuzz["launches"].items()},
            "drivers_launches": drivers["launches"][name]})
    # C3 on lean's inputs (K = 2, one round; also optimal's, K = 5 over
    # two), C4 on dyn1's (one candidate; also dyn2's, two); the plain
    # versions are the torch code these paths ran before the kernels.
    # launches: C3 on the lean main path, C4 over the four greedy tiers
    for name, replaces, key, other, row_launches in (
            ("chain_relax", "libdeflate_tpu/compress/tpu_pipeline.py:690",
             "lean", "optimal", launches["chain_relax"]),
            ("chain_double", "libdeflate_tpu/compress/tpu_pipeline.py:631",
             "dyn1", "dyn2", sum(r["launches"]["chain_extend"]
                                 + r["launches"]["chain_extend2"]
                                 for r in greedy.values()))):
        row = chain_res[f"{name} {key}"]
        by_bytes = row["bytes_bound_ms"] >= row["ops_bound_ms"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "libdeflate_tpu_torch/csrc/chain_extend.cu",
            "replaces": replaces, "launches": row_launches,
            "max_abs_err": max(chain_res["err"][name],
                               soak_fuzz["max_abs_err"][name],
                               drivers["max_abs_err"][name]),
            "ms": row["ms"], "kernel_ms": row["kernel_ms"],
            "kernel_graph_ms": row["kernel_graph_ms"],
            "plain_ms": row["plain_ms"], "plain_turns": row["plain_turns"],
            "bound_ms": max(row["bytes_bound_ms"], row["ops_bound_ms"]),
            "bound_by": "bytes" if by_bytes else "operations",
            "bytes_bound_ms": row["bytes_bound_ms"],
            "ops_bound_ms": row["ops_bound_ms"],
            "library_ms": None, "inputs": row["inputs"],
            other: chain_res[f"{name} {other}"],
            "held": chain_res["held"][name],
            "greedy_tier_launches": {n: r["launches"]["chain_extend"]
                                     + r["launches"]["chain_extend2"]
                                     if name == "chain_double" else
                                     r["launches"]["chain_relax"]
                                     for n, r in greedy.items()},
            "dp_tier_launches": {n: r["launches"][name]
                                 for n, r in dp_tiers.items()},
            "options_launches": opt["launches"][name],
            "whole_file_launches": {level: n[name] for level, n in
                                    file_launches["compress"].items()},
            "soak_fuzz_launches": {k: v[name] for k, v in
                                   soak_fuzz["launches"].items()},
            "drivers_launches": drivers["launches"][name]})
    # C5 on level 6's lean form at 64 x 1 MiB (also dyn1's, the static
    # tier's and the rescue pass's best form); launches on the lean main
    # path
    row = probe_res["main"]["level 6 (lean)"]
    kernels.append({
        "name": "segment_probe", "route": "cuda",
        "source": "libdeflate_tpu_torch/csrc/segment_probe.cu",
        "replaces": "libdeflate_tpu/compress/tpu_pipeline.py:192",
        "launches": launches["segment_probe"],
        "max_abs_err": max(probe_res["err"],
                           soak_fuzz["max_abs_err"]["segment_probe"],
                           drivers["max_abs_err"]["segment_probe"]),
        "ms": row["ms"], "kernel_ms": row["kernel_ms"],
        "kernel_graph_ms": row["kernel_graph_ms"], "sort_ms": row["sort_ms"],
        "plain_ms": row["plain_ms"], "plain_turns": row["turns"]["plain"],
        "bound_ms": row["bytes_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "inputs": row["inputs"],
        **{k: v for k, v in probe_res["main"].items()
           if k != "level 6 (lean)"},
        "held": probe_res["held"],
        "greedy_tier_launches": {n: r["launches"]["segment_probe"]
                                 for n, r in greedy.items()},
        "dp_tier_launches": {n: r["launches"]["segment_probe"]
                             for n, r in dp_tiers.items()},
        "options_launches": sum(c["segment_probe"]
                                for c in opt["chain"].values()),
        "whole_file_launches": {level: n["segment_probe"] for level, n in
                                file_launches["compress"].items()},
        "soak_fuzz_launches": {k: v["segment_probe"] for k, v in
                               soak_fuzz["launches"].items()},
        "drivers_launches": drivers["launches"]["segment_probe"]})
    mesh_launches = mesh_res["launches"]
    for row in kernels:
        name = row["name"]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 mesh_res["side_err"][name])
        if name in ("dp_parse", "pack_groups", "commit_fsm", "code_lens",
                    "chain_relax", "chain_double", "segment_probe"):
            row["mesh_launches"] = {
                f"{k} shards": {level: n[name] for level, n in by.items()}
                for k, by in mesh_launches.items() if k != "decode"}
        elif name in ("decode_chunks", "fsm_decode"):
            row["mesh_launches"] = {
                key: n for key, n in mesh_launches["decode"].items()
                if (name == "fsm_decode") == key.endswith("fsm")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
