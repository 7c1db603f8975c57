"""Build and load the port's CUDA kernels.

No counterpart in ``libdeflate_tpu/``: Pallas kernels compile inside JAX.
The sources are ``csrc/dp_parse.cu`` (K1), ``csrc/pack_groups.cu`` (K2),
``csrc/decode_chunks.cu`` (K3), ``csrc/tokenize_chunks.cu`` (K4),
``csrc/launch_probes.cu`` (K5-K7), ``csrc/fsm_decode.cu`` (F1, the
FSM decoder), ``csrc/commit_fsm.cu`` (C1, the commit FSM) and
``csrc/code_lens.cu`` (C2, the code-length build) and
``csrc/chain_extend.cu`` (C3 and C4, the candidates' chain extension)
and ``csrc/segment_probe.cu`` (C5, the sorted matchfind's probes);
F1 and C1-C5 replace XLA code, not Pallas kernels.  K3 and K4 share
``csrc/inflate_common.cuh``, and F1 keeps its own reader and tables,
since its answers on damaged input are the JAX FSM's, not K3's.  Each source has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so``
at the repository root on first use (or when the source or a header it
includes is newer), then loaded with ``ctypes``.  A missing ``nvcc`` or a
failed build raises.  ``kernel`` hands a wrapper one C launch function
with its ctypes signature, set once when the function is first asked for.

The chunk mesh runs its shards from threads of their own
(``parallel/mesh.py``), so the shared host state here is guarded: one
lock around ``build``, ``load`` and ``kernel`` (threads that first ask
for one kernel at once start one ``nvcc`` and get one function object),
``count_launch`` adds to a wrapper's ``launches`` under a lock, and
``launch_context`` is the one way a wrapper launches: on its tensors'
device, as the current device, and on that device's current stream of
the calling thread.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
KERNEL_SOURCES = ("dp_parse", "pack_groups", "decode_chunks",
                  "tokenize_chunks", "launch_probes", "fsm_decode",
                  "commit_fsm", "code_lens", "chain_extend",
                  "segment_probe")

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}
# builds, loads and function lookups; re-entrant, since kernel() loads
# and load() builds
_lock = threading.RLock()
_count_lock = threading.Lock()

# ctypes types of the launch functions' arguments: device pointers and
# the stream as void*, sizes and flags as int
PTR = ctypes.c_void_p
INT = ctypes.c_int


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` it includes."""
    src = SRC_DIR / f"{name}.cu"
    return [src] + [SRC_DIR / h for h in
                    re.findall(r'#include "([^"]+)"', src.read_text())]


def compile_async(nvcc: str, src: Path, out: Path) -> subprocess.Popen:
    """Start ``nvcc`` on one source for ``sm_90a`` into the shared
    library ``out``; its output (``-Xptxas -v``) is the process's
    stdout."""
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
           str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` each, all started
    together.  Returns the compiler's output (``-Xptxas -v``) per built
    source; raises if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        try:
            for name in names:
                deps, so = sources(name), lib_path(name)
                if so.exists() and so.stat().st_mtime >= max(
                        d.stat().st_mtime for d in deps):
                    continue
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs[name] = (compile_async(nvcc, deps[0], tmp), tmp, so)
            logs = {}
            for name, (proc, tmp, so) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
                os.replace(tmp, so)
                logs[name] = out
            return logs
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


def kernel(name: str, fn_name: str, argtypes):
    """The C function ``fn_name`` of ``csrc/<name>.cu`` (built and loaded
    if needed) with ``argtypes`` and an int result, the CUDA error of the
    launch.  The signature is set on the first call only; later calls
    return the same function object."""
    fn = _functions.get((name, fn_name))
    if fn is None:
        with _lock:
            fn = _functions.get((name, fn_name))
            if fn is None:
                fn = getattr(load(name), fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _functions[name, fn_name] = fn
    return fn


def count_launch(wrapper) -> None:
    """One more launch in ``wrapper.launches``, counted under a lock."""
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def launch_context(tensors, what: str):
    """The launch of the kernel ``what`` on ``tensors``: they must lie on
    one CUDA device, which is the current device inside the context, and
    the context's value is that device's current stream of the calling
    thread, as the C launch functions take it (void*)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: all inputs must lie on one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    dev = devs.pop()
    with torch.cuda.device(dev):
        yield ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
