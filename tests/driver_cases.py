"""The JAX side of the drivers' tests and pins (tests/test_torch_drivers_*.py
and tests/pin_ratio_drivers.py): the scripts' own functions and tables,
taken from ``scripts/`` by ``ast`` where importing a script would run it
or reset JAX's backends, and each ratio configuration of the port's
drivers as the JAX package computes it.

- ``script_defs(script, names, ns)``: the script's top-level functions,
  classes and assignments named ``names``, executed in ``ns``;
- ``main_defs(script, names, ns)``: the functions and assignments named
  ``names`` among the statements of the script's ``main``, executed in
  order;
- ``ABLATE``: ``scripts/ablate_lean.py``'s ``lean_pipeline`` and
  ``ABLATIONS`` with ``dp_parse_pallas`` and ``pack_groups_pallas`` bound
  to ``interpret=True``;
- ``jax_configs()``: the name of every configuration the port's ratio
  drivers pin (``<module>/<variant>``) -> the JAX function of uint8[B, N],
  int32[B], bool[B] -> (words, total_bits) that the script runs for it;
- ``StageJit``, ``stagewise_pallas`` and ``stagewise_ratio_ab``: the same
  JAX functions run stage by stage, each stage jitted once for every case
  of a test file (a test file's JAX compiles dominate its time);
- ``same`` and ``check_entry``: the comparisons, exact.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from libdeflate_tpu.compress import pallas_kernels as plk
from libdeflate_tpu.compress import tpu_dynamic as td
from libdeflate_tpu.compress import tpu_optimal as to
from libdeflate_tpu.compress import tpu_pipeline as tp

REPO = Path(__file__).resolve().parents[1]


def _tree(script: str):
    return ast.parse((REPO / "scripts" / script).read_text())


def _run(nodes, script: str, ns: dict) -> dict:
    exec(compile(ast.Module(nodes, []), f"scripts/{script}", "exec"), ns)
    return ns


def _targets(node) -> set:
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    return set()


def script_defs(script: str, names, ns: dict) -> dict:
    keep = [n for n in _tree(script).body if _targets(n) & set(names)]
    return _run(keep, script, ns)


def main_defs(script: str, names, ns: dict) -> dict:
    """The functions and assignments named ``names`` among the statements
    of the script's ``main``, executed in order in ``ns``."""
    main = next(n for n in _tree(script).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keep = [n for n in main.body if _targets(n) & set(names)]
    return _run(keep, script, ns)


def same(got, want, what: str = "") -> None:
    """The port's output (tensors, nested in tuples and lists) equals the
    JAX one: shapes equal (a [1, n] port array stands for JAX's
    per-chunk rows of one value), values equal modulo 2**32 where JAX
    keeps 32 bits."""
    import torch
    if isinstance(got, (tuple, list)):
        assert isinstance(want, (tuple, list)) and len(got) == len(want), \
            what
        for k, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{k}]")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if g.ndim == w.ndim and g.shape[0] == 1 and w.shape[0] > 1:
        w = w[:1]
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype == bool or g.dtype == bool:
        assert np.array_equal(g.astype(bool), w.astype(bool)), what
        return
    m = (1 << 32) - 1
    assert np.array_equal(g.astype(np.int64) & m, w.astype(np.int64) & m), \
        what


class StageJit:
    """Stands where a script names ``jax``: ``vmap(f)`` runs
    ``jax.jit(jax.vmap(f))``, each stage one jitted function (its
    floating-point arithmetic fused as in the script's whole-pipeline
    jit), with the compiled stage kept by its jaxpr: a stage whose trace
    repeats an earlier one (another ablation, another chunk) reuses that
    compile.  The functions named in ``eager`` (integer arithmetic only)
    run op by op instead, which skips their compile.  Everything else is
    JAX's."""

    def __init__(self, eager=()):
        self.cache = {}      # jaxpr text -> jitted evaluation
        self.traced = {}     # function, closure values, shapes -> a trace
        self.eager = set(eager)

    def vmap(self, f):
        vf = jax.vmap(f)
        if f.__name__ in self.eager:
            return vf

        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            try:
                k1 = (f.__code__, f.__defaults__,
                      tuple(c.cell_contents for c in f.__closure__ or ()),
                      tree, tuple((x.shape, str(x.dtype)) for x in leaves))
                hash(k1)
            except TypeError:          # unhashable closure: trace anew
                k1 = None
            hit = self.traced.get(k1) if k1 is not None else None
            if hit is None:
                closed, shape = jax.make_jaxpr(vf, return_shape=True)(*args)
                key = str(closed.jaxpr)
                if key not in self.cache:
                    jaxpr = closed.jaxpr
                    self.cache[key] = jax.jit(
                        lambda consts, *a: jax.core.eval_jaxpr(jaxpr, consts,
                                                               *a))
                hit = (self.cache[key], closed.consts,
                       jax.tree_util.tree_structure(shape))
                if k1 is not None:
                    self.traced[k1] = hit
            fn, consts, out_tree = hit
            return jax.tree_util.tree_unflatten(out_tree, fn(consts, *leaves))
        return call

    def __getattr__(self, name):
        return getattr(jax, name)


def jitted_kernels() -> dict:
    """``dp_parse_pallas`` and ``pack_groups_pallas`` in interpret mode,
    jitted with their static arguments (one compile a shape)."""
    return {"dp_parse_pallas": jax.jit(
                functools.partial(plk.dp_parse_pallas, interpret=True),
                static_argnames=("S", "ladder")),
            "pack_groups_pallas": jax.jit(
                functools.partial(plk.pack_groups_pallas, interpret=True),
                static_argnums=2)}


def ablate_ns(jax_module=jax, kernels=None) -> dict:
    """``lean_pipeline`` and ``ABLATIONS`` of ``scripts/ablate_lean.py``,
    the kernels in interpret mode; ``jax_module`` stands where the script
    names ``jax`` and ``kernels`` binds the kernels (the tests pass a
    ``StageJit`` and ``jitted_kernels()``)."""
    ns = {"jax": jax_module, "jnp": jnp, "to": to, "tp": tp, "td": td,
          **(kernels or {
              "dp_parse_pallas": functools.partial(plk.dp_parse_pallas,
                                                   interpret=True),
              "pack_groups_pallas": functools.partial(
                  plk.pack_groups_pallas, interpret=True)})}
    return script_defs("ablate_lean.py",
                       ("lean_pipeline", "ABLATIONS", "DEPTH", "LADDER",
                        "CHUNK", "BATCH"), ns)


ABLATE = ablate_ns()
RATIO_AB = script_defs("ratio_ab.py", ("VARIANTS",), {})["VARIANTS"]
CORPUS2_VARIANTS = script_defs("exp_corpus2_breadth.py", ("variants",),
                               {"functools": functools})["variants"]()
BIAS_SHAPES = main_defs("exp_match_bias.py", ("f259", "shapes"),
                        {"np": np})["shapes"]
# exp_match_bias.py's keywords (lines 34-38), its bias traced
MATCH_BIAS = dict(depth=6, two_pass=False, hash3=False, use_content=False,
                  use_wide=False, ladder=to.LEN_LADDER_DENSE2, ext_c=False,
                  strides2=(), refine=0, lit_sample=4)
# exp_r5_speed.py's lean keywords (lines 75-78) and dynamic ones (84-85)
R5_LEAN = dict(depth=6, two_pass=False, hash3=False, passes=1,
               use_content=False, use_wide=False,
               ladder=to.LEN_LADDER_DENSE2, ext_c=False, strides2=(),
               refine=0, lit_sample=4)
R5_DYN = dict(two_pass=False, depth=6, hash3=False)


def ratio_ab_fn(name: str):
    """``scripts/ratio_ab.py``'s ``one`` (lines 58-68) for a variant,
    batched."""
    kw, refine = RATIO_AB[name]

    def one(b, l, f):
        bp, pos, cm, cl, eff, dist = to.parse_chunk_optimal(
            b, l, depth=6, two_pass=False, hash3=False, wide_window=True,
            passes=1, use_content=False, use_wide=False,
            ladder=to.LEN_LADDER_DENSE2, ext_c=False, **kw)
        return td.emit_dynamic_block(bp, f, cm, cl, eff, dist, b.shape[0],
                                     bp.shape[0], refine_passes=refine)
    return jax.jit(jax.vmap(one))


def match_bias_fn(passes: int = 1):
    """``scripts/exp_match_bias.py``'s ``fn`` (lines 34-38): one compile
    for every bias, the [259] bias traced."""
    return jax.jit(lambda b, l, f, bias: to._compress_chunks_optimal_pallas(
        b, l, f, passes=passes, match_bias16=bias, interpret=True,
        **MATCH_BIAS))


def bias16(name: str) -> np.ndarray:
    return np.round(BIAS_SHAPES[name] * 16).astype(np.int32)


def _pallas(fn):
    return jax.jit(functools.partial(fn, interpret=True))


def jax_configs() -> dict:
    """name -> the JAX function the script runs for it (B = 1 calls at
    1 MiB; at 1 MiB the XLA and Pallas twins of one configuration give
    the same bits, ``tests/pin_dp_total_bits.py``)."""
    out = {f"ratio_ab/{k}": ratio_ab_fn(k) for k in RATIO_AB}
    out.update({f"exp_corpus2_breadth/{k}": _pallas(v)
                for k, v in CORPUS2_VARIANTS.items()})
    mb = match_bias_fn()
    out.update({f"exp_match_bias/{k}": functools.partial(
        lambda b, l, f, _bias: mb(b, l, f, _bias), _bias=jnp.asarray(
            bias16(k))) for k in BIAS_SHAPES})
    lean = functools.partial(to._compress_chunks_optimal_pallas, **R5_LEAN)
    out["exp_r5_speed/lean-base"] = _pallas(lean)
    out["exp_r5_speed/lean-s5"] = _pallas(functools.partial(
        lean, strides1=(1, 2, 8, 32, 128)))
    out["exp_r5_speed/lean-s4"] = _pallas(functools.partial(
        lean, strides1=(1, 4, 16, 128)))
    dyn = functools.partial(td._compress_chunks_dynamic_pallas, **R5_DYN)
    out["exp_r5_speed/dyn-base"] = _pallas(dyn)
    for name, kw in (("dyn-lcp8", dict(lcp=8)),
                     ("dyn-lcp8-d4", dict(lcp=8, depth=4)),
                     ("dyn-lcp8-d8", dict(lcp=8, depth=8))):
        out[f"exp_r5_speed/{name}"] = _pallas(functools.partial(dyn, **kw))
    out.update({"exp_dp_corpus/dyn1": td.compress_chunks_dynamic,
                "exp_dp_corpus/dp": to.compress_chunks_optimal,
                "exp_dp_corpus/dpD": to.compress_chunks_optimal_deep,
                "exp_ratio_gap/dyn1 (L2-6)": td.compress_chunks_dynamic,
                "exp_ratio_gap/dyn2 (L7)": td.compress_chunks_dynamic2,
                "exp_ratio_gap/dyn3 (L8+)": td.compress_chunks_dynamic3})
    return out


def ratio_gap_recost(b, l):
    """``scripts/exp_ratio_gap.py``'s re-costing (lines 73-118) of one
    batch: per chunk the bits under the device's code lengths ("kraft")
    and package-merge at 11 and 15 bits."""
    from libdeflate_tpu.huffman.build import package_merge_lengths
    parse = jax.jit(jax.vmap(lambda bb, ll: tp._parse_chunk(
        bb, ll, lazy=True, two_pass=False, depth=6, hash3=False,
        wide_ext=False, wide_window=True)))
    device_lens = jax.jit(lambda hl, hd: (
        td._build_code_lens(hl, td.NSYM, 0)[0],
        td._build_code_lens(hd, td.NDIST, 0)[0]))
    bp, pos, cm, cl, eff, dist = map(np.asarray, parse(b, l))
    out = {"kraft": [], "pm11": [], "pm15": []}
    for k in range(bp.shape[0]):
        lits = bp[k][cl[k]]
        mlen, mdist = eff[k][cm[k]], dist[k][cm[k]]
        hl = np.bincount(lits, minlength=td.NSYM).astype(np.int64)
        lslot, _, lextra = map(np.asarray, tp._length_slot(jnp.asarray(mlen)))
        oslot, _, oextra = map(np.asarray, tp._offset_slot(jnp.asarray(mdist)))
        hl[257:] = 0
        hl[257 + np.arange(29)] = np.bincount(lslot, minlength=29)[:29]
        hl[256] = 1
        hd = np.bincount(oslot, minlength=td.NDIST).astype(np.int64)
        extra = int(np.sum(lextra) + np.sum(oextra))
        ll, dl = map(np.asarray, device_lens(jnp.asarray(hl, jnp.int32),
                                             jnp.asarray(hd, jnp.int32)))
        out["kraft"].append(int(np.sum(hl * ll) + np.sum(hd * dl)) + extra
                            + td.HDR_BITS)
        for cap in (11, 15):
            l1 = package_merge_lengths(hl, cap)
            l2 = package_merge_lengths(
                np.maximum(hd, np.where(np.arange(td.NDIST) < 2, 1, 0)), cap)
            out[f"pm{cap}"].append(int(np.sum(hl * l1) + np.sum(hd * l2))
                                   + extra + td.HDR_BITS)
    return out


class _Kernels:
    """While entered, ``pallas_kernels.dp_parse_pallas`` and
    ``pack_groups_pallas`` are jitted with their static arguments (the
    JAX functions import them at call time), so that a function run
    outside one jit compiles each kernel once a shape."""

    def __enter__(self):
        self.orig = plk.dp_parse_pallas, plk.pack_groups_pallas
        plk.dp_parse_pallas = jax.jit(
            self.orig[0], static_argnames=("S", "interpret", "ladder"))
        plk.pack_groups_pallas = jax.jit(
            self.orig[1], static_argnums=(2,),
            static_argnames=("nwords", "interpret"))
        return self

    def __exit__(self, *exc):
        plk.dp_parse_pallas, plk.pack_groups_pallas = self.orig


def stagewise_pallas():
    """``tpu_optimal._compress_chunks_optimal_pallas``, taken from its
    source by ``ast`` into a copy of its module's namespace and run stage
    by stage: its ``jax.vmap`` stages through a ``StageJit`` (one compile
    a stage across configurations), its candidates (``cand``: integer
    arithmetic) op by op with ``_literal_costs`` jitted, its kernels
    jitted in interpret mode.  Returns fn(bufs, lengths, bfinal,
    **keywords) -> (words, total_bits) as numpy arrays."""
    src = Path(to.__file__)
    node = next(n for n in ast.parse(src.read_text()).body
                if isinstance(n, ast.FunctionDef)
                and n.name == "_compress_chunks_optimal_pallas")
    ns = dict(vars(to))
    ns["jax"] = StageJit(eager=("cand",))
    ns["_literal_costs"] = jax.jit(to._literal_costs, static_argnums=(2,),
                                   static_argnames=("sample",))
    exec(compile(ast.Module([node], []), str(src), "exec"), ns)

    def run(bufs, lengths, bfinal, **kw):
        with _Kernels():
            w, t = ns["_compress_chunks_optimal_pallas"](
                jnp.asarray(bufs), jnp.asarray(lengths), jnp.asarray(bfinal),
                interpret=True, **kw)
        return np.asarray(w), np.asarray(t)
    return run


def check_entry(got, want, bufs, lengths):
    """The port's (words, total_bits) equal the JAX ones, chunk by chunk,
    and each stream inflates to its chunk."""
    import zlib

    import libdeflate_tpu_torch as lt
    words, total_bits = got
    w_j, t_j = want
    for k in range(bufs.shape[0]):
        assert int(total_bits[k]) == int(t_j[k])
        assert np.array_equal(words[k].numpy().view(np.uint32),
                              np.asarray(w_j[k]))
        stream = lt.device_stream_to_bytes(words[k], total_bits[k])
        assert zlib.decompressobj(-15).decompress(stream) == \
            bufs[k, :lengths[k]].tobytes()


def check_stagewise(run, port_fn, jax_kw, args):
    """``port_fn`` (the port's entry of a configuration) on the batch
    ``args`` against ``stagewise_pallas()``'s run of the script's keywords
    ``jax_kw`` on the whole batch (one cost pass: the Pallas DP reads one
    [259] cost table for every chunk)."""
    bufs, lengths, bfinal = args
    got = port_fn(bufs, lengths, bfinal, device="cpu")
    check_entry(got, run(bufs, lengths, bfinal, **jax_kw), bufs, lengths)


def stagewise_ratio_ab():
    """``scripts/ratio_ab.py``'s ``one`` run stage by stage:
    ``parse_chunk_optimal`` taken from ``tpu_optimal.py``'s source by
    ``ast`` into a copy of its module's namespace, its candidates
    (integer arithmetic) op by op and its ``_literal_costs``,
    ``_dp_parse`` and ``_commit`` each jitted, and ``emit_dynamic_block``
    jitted, under a vmap run op by op: one compile a stage for every
    variant.  Returns fn(name, bufs, lengths, bfinal) -> (words,
    total_bits) as numpy arrays."""
    src = Path(to.__file__)
    node = next(n for n in ast.parse(src.read_text()).body
                if isinstance(n, ast.FunctionDef)
                and n.name == "parse_chunk_optimal")
    ns = dict(vars(to))
    ns["_literal_costs"] = jax.jit(to._literal_costs, static_argnums=(2,),
                                   static_argnames=("sample",))
    ns["_dp_parse"] = jax.jit(to._dp_parse, static_argnums=(13,),
                              static_argnames=("ladder",))
    ns["_commit"] = jax.jit(to._commit, static_argnums=(4,))
    exec(compile(ast.Module([node], []), str(src), "exec"), ns)
    emit = jax.jit(td.emit_dynamic_block, static_argnums=(6, 7),
                   static_argnames=("refine_passes",))

    def run(name, bufs, lengths, bfinal):
        kw, refine = RATIO_AB[name]

        def one(b, l, f):
            bp, pos, cm, cl, eff, dist = ns["parse_chunk_optimal"](
                b, l, depth=6, two_pass=False, hash3=False, wide_window=True,
                passes=1, use_content=False, use_wide=False,
                ladder=to.LEN_LADDER_DENSE2, ext_c=False, **kw)
            return emit(bp, f, cm, cl, eff, dist, b.shape[0], bp.shape[0],
                        refine_passes=refine)
        w, t = jax.vmap(one)(jnp.asarray(bufs), jnp.asarray(lengths),
                             jnp.asarray(bfinal))
        return np.asarray(w), np.asarray(t)
    return run
