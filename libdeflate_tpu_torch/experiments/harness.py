"""What the measurement scripts share: kernel sources built side by side,
named by their content, and the recording of a kernel wrapper's calls.

``build_tagged`` serves ``fsm_variants.py``, ``dp_variants.py`` and
``scan_variants.py`` (a kernel's variants, or an earlier tree's source,
beside the as-built one) and ``chip_smoke.py`` (its launch-floor probe);
``record_calls`` and ``record_many`` serve ``scan_variants.py`` and
``chip_smoke.py`` (a tier's own kernel inputs from one real call).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

from .. import _build

VARIANT_DIR = _build.BUILD_DIR.parent / "variants"


def build_lines(log: str) -> list[str]:
    """The register, shared-memory and spill lines of a build's
    ``-Xptxas -v`` output."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build_tagged(sources: dict) -> tuple[dict, dict]:
    """Build every source of ``sources`` ({key: (stem, CUDA text)}) into
    ``VARIANT_DIR`` as ``lib<stem>_<tag>.so``, the tag a hash of the
    text, every ``nvcc`` started together: ({key: the loaded library},
    {key: build lines}).  A process loads each library path once, so two
    sources never share one, and equal sources are built once.  Raises
    if a build fails."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    tags, procs = {}, {}
    for key, (stem, text) in sources.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        tag = tags[key] = f"{stem}_{digest}"
        if tag not in procs:
            cu = VARIANT_DIR / f"{tag}.cu"
            cu.write_text(text)
            so = VARIANT_DIR / f"lib{tag}.so"
            procs[tag] = (_build.compile_async(nvcc, cu, so), so)
    logs = {}
    for tag, (proc, so) in procs.items():
        logs[tag], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{logs[tag]}")
    libs = {tag: ctypes.CDLL(str(so)) for tag, (_, so) in procs.items()}
    return ({key: libs[tag] for key, tag in tags.items()},
            {key: build_lines(logs[tag]) for key, tag in tags.items()})


class Recording:
    """A kernel wrapper that keeps each call's positional arguments,
    result and calling thread's name, in the order the calls ended (a
    mesh's shards call from threads of their own); its ``launches`` is
    the wrapper's own, so the wrapper's count, which reads its module's
    name, goes on counting."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.seen = []
        self.results = []
        self.threads = []
        self._lock = threading.Lock()

    def __call__(self, *args):
        result = self.wrapper(*args)
        with self._lock:
            self.seen.append(args)
            self.results.append(result)
            self.threads.append(threading.current_thread().name)
        return result

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, value):
        self.wrapper.launches = value


def record_calls(module, name: str, fn):
    """fn() with ``module.name`` wrapped so that each call's positional
    arguments are kept: (fn's result, the argument tuples).  The entries
    call the kernel wrappers through their module, so this captures a
    tier's own kernel inputs in one real call."""
    orig = getattr(module, name)
    rec = Recording(orig)
    setattr(module, name, rec)
    try:
        return fn(), rec.seen
    finally:
        setattr(module, name, orig)


def record_many(targets, fn):
    """fn() with each (module, name) of ``targets`` recorded as
    ``record_calls`` records one: (fn's result, {name: the argument
    tuples})."""
    if not targets:
        return fn(), {}
    (module, name), rest = targets[0], targets[1:]
    (result, calls), seen = record_calls(module, name,
                                         lambda: record_many(rest, fn))
    return result, {name: seen, **calls}
