"""The port's stage profiles (``libdeflate_tpu_torch/experiments/
profile_lean.py`` and ``profile_opt.py``) against the JAX functions that
``scripts/profile_lean.py`` and ``scripts/profile_opt.py`` call, with the
scripts' arguments.

One batch of ``tests/dp_tier_cases.py``: two 64 KiB chunks (SURVEY.md
text, and records 40000 bytes long).  The port's stages run once through
each profiler's ``stages`` (no timing); the JAX stages chain as each
script chains them, each on the previous JAX stage's output: the
candidates, the position passes and the content pass (the scripts'
``posonly``, ``cand_posonly`` and ``cand_content``, taken from their
``main`` by ``ast``) and the chain extensions op by op (integer only);
the literal costs, commit, code lengths, emit, premerge and XLA's
``_group_place`` jitted, once for both scripts (``jitted``); K1 and K2 as
``dp_parse_pallas`` and ``pack_groups_pallas`` in interpret mode (one
[259] cost table: the Pallas DP reads it the same for every chunk).
Every stage equal, tolerance 0; each profiled chain's stream inflates
through zlib.  The FULL lines are tier entries, held to the JAX package
by the tier and options tests.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import pytest
import torch

import dp_tier_cases as dtc
import driver_cases as dc
import libdeflate_tpu_torch as lt
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu.compress.pallas_kernels import (dp_parse_pallas,
                                                    pack_groups_pallas)
from libdeflate_tpu_torch.experiments import profile_lean, profile_opt
from libdeflate_tpu_torch.experiments.driver_common import Bench

one_torch_thread = dtc.one_torch_thread
NS = {"jax": jax, "jnp": jnp, "tp": tp}
LEAN = dc.main_defs("profile_lean.py", ("posonly",), dict(NS))
OPT = dc.main_defs("profile_opt.py", ("depth", "cand_posonly",
                                      "cand_content"), dict(NS))
LADDERS = {"sparse28": to.LEN_LADDER, "dense46": to.LEN_LADDER_DENSE,
           "dense2_80": to.LEN_LADDER_DENSE2}
N_PAD = dtc.N


@functools.lru_cache(maxsize=None)
def jitted(stage, arg=None):
    """The scripts' jitted stages, compiled once for both scripts."""
    if stage == "literal":
        return jax.jit(jax.vmap(
            lambda b, l: to._literal_costs(b, l, N_PAD)[0]))
    if stage == "dp":
        return jax.jit(functools.partial(dp_parse_pallas, S=to.DP_SEG,
                                         ladder=arg, interpret=True))
    if stage == "commit":
        return jax.jit(jax.vmap(lambda s, d, p, l: to._commit(
            s, d, p, l, to.DP_SEG)))
    if stage == "emit_pre":
        return jax.jit(jax.vmap(lambda b, m, l, e, d: td._emit_dynamic_pre(
            b, m, l, e, d, N_PAD, arg)))
    if stage == "premerge":
        return jax.jit(jax.vmap(lambda v, n, o: tp._group_premerge(
            v, n, o, capw=arg)))
    if stage == "pack":
        return jax.jit(functools.partial(pack_groups_pallas, nwords=arg,
                                         interpret=True))
    raise KeyError(stage)


def _chain(bufs, lengths, cands, out, ladders):
    """The scripts' common chain from the candidates on."""
    bp, pos = cands[0], cands[1]
    lenA, dA, lenB, dB, lenC, dC, d3 = cands[2:]
    cost_lit = jitted("literal")(bp, lengths)
    out["_literal_costs (257-sym hist)"] = cost_lit
    cd = [to._dist_cost(d) for d in (dA, dB, dC, d3)]
    out["dist costs x4"] = cd
    for name in ladders:
        span, dist = jitted("dp", LADDERS[name])(
            cost_lit, lenA, dA, cd[0], lenB, dB, cd[1], lenC, dC, cd[2], d3,
            cd[3], jnp.asarray(to._SEED_LC_LEN))
        out[f"DP K1 [{name}]"] = (span, dist)
    cm, cl, eff = jitted("commit")(span, dist, pos, lengths)
    out["commit C1 (merge)"] = (cm, cl, eff)
    return bp, cm, cl, eff, dist


@functools.lru_cache(maxsize=None)
def port(mod):
    bufs, lengths, bfinal = dtc.batch()
    bench = Bench(torch.device("cpu"), 0, 2)
    return mod.stages(torch.from_numpy(bufs.copy()),
                      torch.as_tensor(lengths, dtype=torch.int64),
                      torch.as_tensor(bfinal), bench)


@functools.lru_cache(maxsize=None)
def script_lean():
    """``scripts/profile_lean.py``'s stages in JAX: {line name: output}."""
    bufs, lengths, bfinal = (jnp.asarray(x) for x in dtc.batch())
    out = {}
    cands = jax.vmap(lambda b, l: tp._parse_candidates(
        b, l, depth=6, two_pass=False, hash3=False, wide_window=True,
        use_content=False, use_wide=False))(bufs, lengths)
    out["_parse_candidates LEAN total"] = cands
    raws = jax.vmap(LEAN["posonly"])(bufs, lengths)
    out["  pos-pass sort (5 ops, triple)"] = raws
    flat3 = [x for tri in raws for x in tri]
    out["  chain_extend_multi x3"] = jax.vmap(
        lambda *a: tp._chain_extend_multi([a[0:3], a[3:6], a[6:9]]))(*flat3)
    out["  chain_extend_multi x2 (no C)"] = jax.vmap(
        lambda *a: tp._chain_extend_multi([a[0:3], a[3:6]]))(*flat3[:6])
    bp, cm, cl, eff, dist = _chain(bufs, lengths, cands, out, LADDERS)
    for rp in (16, 4, 0):
        out[f"_emit_dynamic_pre refine={rp}"] = jitted("emit_pre", rp)(
            bp, cm, cl, eff, dist)
    (val, nb, offs), aux = out["_emit_dynamic_pre refine=16"]
    sbuf, gw = jitted("premerge", td.DYN_CAPW_DEEP)(val, nb, offs)
    out["_group_premerge cap61"] = (sbuf, gw)
    out["pack_groups K2"] = jitted("pack", td._dyn_nwords(bufs.shape[1]))(
        sbuf, gw)
    return out


@functools.lru_cache(maxsize=None)
def script_opt():
    """``scripts/profile_opt.py``'s stages in JAX: {line name: output}."""
    bufs, lengths, bfinal = (jnp.asarray(x) for x in dtc.batch())
    out = {}
    raws = jax.vmap(OPT["cand_posonly"])(bufs, lengths)
    out["pos-pass sort (9 ops, triple)"] = raws
    craw = jax.vmap(OPT["cand_content"])(bufs, lengths)
    out["content pass (11 ops, 3 keys)"] = craw
    flat = [x for tri in raws for x in tri] + [craw[k] for k in range(6)]
    out["chain_extend_multi x5"] = jax.vmap(lambda *a: tp._chain_extend_multi(
        [a[i:i + 3] for i in range(0, 15, 3)]))(*flat)
    out["chain_extend_multi x3"] = jax.vmap(lambda *a: tp._chain_extend_multi(
        [a[i:i + 3] for i in range(0, 9, 3)]))(*flat[:9])
    cands = jax.vmap(lambda b, l: tp._parse_candidates(
        b, l, depth=6, two_pass=False, hash3=False, wide_window=True))(
        bufs, lengths)
    out["_parse_candidates total"] = cands
    bp, cm, cl, eff, dist = _chain(bufs, lengths, cands, out, ("sparse28",))
    out["code_lens_from_items (C2, 316 syms)"] = jax.jit(jax.vmap(
        lambda *a: to._code_lens_from_items(*a, N_PAD)))(
        bp, cm, cl, eff, dist)
    for rp, cap in ((16, 15), (0, 11)):
        out[f"_emit_dynamic_pre refine={rp} cap{cap}"] = jitted(
            "emit_pre", rp)(bp, cm, cl, eff, dist)
    (val, nb, offs), aux = out["_emit_dynamic_pre refine=16 cap15"]
    for capw in (td.DYN_CAPW_DEEP, td.DYN_CAPW):
        out[f"_group_premerge cap{capw}"] = jitted("premerge", capw)(
            val, nb, offs)
    sbuf, gw = out["_group_premerge cap61"]
    nwords = td._dyn_nwords(bufs.shape[1])
    out["pack_groups K2 cap61"] = jitted("pack", nwords)(sbuf, gw)
    out["group_place cap61 (K2's plain version)"] = jax.jit(jax.vmap(
        lambda s, g: tp._group_place(s, g, nwords)))(sbuf, gw)
    return out


LEAN_STAGES = [
    "_parse_candidates LEAN total", "  pos-pass sort (5 ops, triple)",
    "  chain_extend_multi x3", "  chain_extend_multi x2 (no C)",
    "_literal_costs (257-sym hist)", "dist costs x4",
    *(f"DP K1 [{k}]" for k in LADDERS), "commit C1 (merge)",
    *(f"_emit_dynamic_pre refine={r}" for r in (16, 4, 0)),
    "_group_premerge cap61", "pack_groups K2"]
OPT_STAGES = [
    "pos-pass sort (9 ops, triple)", "content pass (11 ops, 3 keys)",
    "chain_extend_multi x5", "chain_extend_multi x3",
    "_parse_candidates total", "_literal_costs (257-sym hist)",
    "dist costs x4", "DP K1 [sparse28]", "commit C1 (merge)",
    "code_lens_from_items (C2, 316 syms)",
    "_emit_dynamic_pre refine=16 cap15", "_emit_dynamic_pre refine=0 cap11",
    "_group_premerge cap61", "_group_premerge cap45", "pack_groups K2 cap61",
    "group_place cap61 (K2's plain version)"]
CASES = ([("lean", s) for s in LEAN_STAGES]
         + [("opt", s) for s in OPT_STAGES])
PROFILES = {"lean": (profile_lean, script_lean, "FULL lean1J (p1, dense2)"),
            "opt": (profile_opt, script_opt, "FULL opt2-pallas")}


def flat(x):
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in flat(item)]
    return [x]


@pytest.mark.parametrize("profile,stage", CASES,
                         ids=[f"{p}:{s.strip()}" for p, s in CASES])
def test_stage_equals_the_scripts(profile, stage):
    mod, script, _ = PROFILES[profile]
    got, want = port(mod)[stage], script()[stage]
    if "pos-pass" in stage or stage.startswith("content"):
        got, want = flat(got), flat(want)
    dc.same(got, want, stage)


@pytest.mark.parametrize("profile", PROFILES)
def test_profiled_chain_inflates(profile):
    mod, _, full = PROFILES[profile]
    bufs, lengths, _ = dtc.batch()
    words, total_bits = port(mod)["stream"]
    assert full in port(mod)
    for k in range(2):
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()
