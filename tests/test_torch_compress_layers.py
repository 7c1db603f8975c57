"""The compress layer's direction: primitives, kernel wrappers, stages.

``libdeflate_tpu_torch/compress/`` is three layers whose imports point
down only: the primitives (``bits``), the kernel wrappers (``kernels``,
``scan_kernels``, ``chain_kernels``, ``probe_kernels``), each holding
its kernels' plain versions, and the stages and tiers (``pipeline``,
``dynamic``, ``optimal``), which import the wrappers once, at the top.
Read with ``ast`` (no module is run but to read a function's
``__module__``):

- (a) no module of the three layers imports inside a function body;
- (b) ``bits`` imports nothing of the package, and no wrapper module
  imports a stage module;
- (c) each plain version is defined in its wrapper's own module;
- (d) no public function name is defined in two of the modules, but
  ``reset_launch_counts``.
"""

import ast
import importlib
from collections import Counter
from pathlib import Path

import pytest

PACKAGE = "libdeflate_tpu_torch.compress"
PRIMITIVES = ("bits",)
WRAPPERS = ("kernels", "scan_kernels", "chain_kernels", "probe_kernels")
STAGES = ("pipeline", "dynamic", "optimal")
MODULES = PRIMITIVES + WRAPPERS + STAGES
# each wrapper module's plain versions of its kernels
PLAIN = {"kernels": ("dp_parse_plain", "group_place"),
         "scan_kernels": ("greedy_commit_merge", "build_code_lens"),
         "chain_kernels": ("chain_extend_plain", "chain_extend2_plain",
                           "chain_extend_multi_plain"),
         "probe_kernels": ("sorted_best", "sorted_matchfind_lean")}
DIR = Path(__file__).resolve().parents[1] / "libdeflate_tpu_torch" / "compress"


def tree(name: str) -> ast.Module:
    return ast.parse((DIR / f"{name}.py").read_text())


def imported(node) -> list[str]:
    """The modules an import statement names, absolute, with a relative
    ``from . import x`` as the package's ``x``."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if node.level == 0:
        return [node.module]
    base = "libdeflate_tpu_torch" if node.level == 2 else PACKAGE
    if node.module:
        return [f"{base}.{node.module}"]
    return [f"{base}.{a.name}" for a in node.names]


def imports(name: str) -> list[str]:
    return [m for node in ast.walk(tree(name))
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for m in imported(node)]


@pytest.mark.parametrize("name", MODULES)
def test_no_import_in_a_function_body(name):
    inner = [f"{fn.name}:{node.lineno}" for fn in ast.walk(tree(name))
             if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda))
             for node in ast.walk(fn)
             if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not inner, f"{name} imports inside {inner}"


@pytest.mark.parametrize("name", PRIMITIVES + WRAPPERS)
def test_imports_point_down(name):
    got = imports(name)
    if name in PRIMITIVES:
        assert not [m for m in got if m.startswith("libdeflate_tpu_torch")]
    up = [m for m in got if m in {f"{PACKAGE}.{s}" for s in STAGES}]
    assert not up, f"{name} imports the stage modules {up}"


@pytest.mark.parametrize("name,plain", [(m, p) for m, ps in PLAIN.items()
                                        for p in ps])
def test_plain_version_in_its_wrapper_module(name, plain):
    fn = getattr(importlib.import_module(f"{PACKAGE}.{name}"), plain)
    assert fn.__module__ == f"{PACKAGE}.{name}"


def test_one_home_a_public_function():
    defs = Counter(node.name for name in MODULES
                   for node in tree(name).body
                   if isinstance(node, ast.FunctionDef)
                   and not node.name.startswith("_"))
    twice = sorted(n for n, k in defs.items()
                   if k > 1 and n != "reset_launch_counts")
    assert not twice, f"defined in two modules: {twice}"
