"""ctypes bindings for the native host codec (native/ldtpu_native.cpp).

Builds the shared library on demand with g++ (no pybind11 dependency —
plain C ABI).  Set LIBDEFLATE_TPU_NO_NATIVE=1 to force the pure-Python host
path (the analogue of the reference's LIBDEFLATE_DISABLE_CPU_FEATURES
forced-dispatch test hook, scripts/run_tests.sh:133-165); it is read once,
at the first ``get_lib()``, and the answer is kept for the process.

The port's own copy of ``libdeflate_tpu/native_backend.py``: the same C ABI,
``ctypes`` signatures and knobs, compiling the same source, the repo's
``native/ldtpu_native.cpp``.  It builds into ``build/native/`` and never
into ``native/``, whose library belongs to the JAX package, and it compiles
to a temporary file that ``os.replace`` moves into place, so that processes
building at once each load a whole library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "ldtpu_native.cpp")
_SO = os.path.join(_REPO, "build", "native", "libldtpu_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_tag() -> str:
    """Host identity for the cached -march=native build: a .so built on one
    CPU must not be loaded on another (SIGILL risk)."""
    import hashlib
    import platform

    bits = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "model name")):
                    bits += line
                    break
    except OSError:
        pass
    return hashlib.sha256(bits.encode()).hexdigest()[:16]


def _build() -> bool:
    # -march=native matters for the decoder's shift-heavy bit cursor (SHRX
    # etc. — the analogue of the reference's BMI2 decode variant, measured
    # +12% on text-like data); fall back to the portable build if the local
    # toolchain rejects it.
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        for cmd in (base[:2] + ["-march=native"] + base[2:], base):
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            except Exception:
                continue
            with open(tmp + ".cputag", "w") as f:
                f.write(_cpu_tag())
            os.replace(tmp, _SO)
            os.replace(tmp + ".cputag", _SO + ".cputag")
            return True
        return False
    finally:
        for path in (tmp, tmp + ".cputag"):
            if os.path.exists(path):
                os.remove(path)


def _cached_build_usable() -> bool:
    if not os.path.exists(_SO):
        return False
    if os.path.exists(_SRC) and os.path.getmtime(_SO) <= os.path.getmtime(_SRC):
        return False
    try:
        with open(_SO + ".cputag") as f:
            return f.read().strip() == _cpu_tag()
    except OSError:
        return False  # unknown provenance: rebuild for this host


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LIBDEFLATE_TPU_NO_NATIVE"):
            return None
        # explicit .so override: lets the test harness point every native
        # call at an instrumented build (ASAN/UBSAN — the reference's
        # sanitizer run_tests modes, scripts/run_tests.sh:262-307)
        so_path = os.environ.get("LIBDEFLATE_TPU_NATIVE_SO", _SO)
        if so_path == _SO and not _cached_build_usable():
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.ld_crc32.restype = ctypes.c_uint32
        lib.ld_crc32.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.ld_adler32.restype = ctypes.c_uint32
        lib.ld_adler32.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.ld_deflate_compress.restype = ctypes.c_size_t
        lib.ld_deflate_compress.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ld_deflate_decompress.restype = ctypes.c_int
        lib.ld_deflate_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _buf_ptr(data):
    """(pointer, nbytes) for bytes or any buffer-protocol object, without
    copying — a numpy view keeps its (possibly misaligned) address, which
    the checksum program's -m option relies on."""
    if isinstance(data, bytes):
        return data, len(data)
    import numpy as np

    arr = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    return ctypes.cast(arr.ctypes.data, ctypes.c_char_p), arr.nbytes


def crc32(data, crc: int = 0) -> int:
    ptr, n = _buf_ptr(data)
    return int(get_lib().ld_crc32(crc & 0xFFFFFFFF, ptr, n))


def adler32(data, adler: int = 1) -> int:
    ptr, n = _buf_ptr(data)
    return int(get_lib().ld_adler32(adler & 0xFFFFFFFF, ptr, n))


def deflate_compress(data: bytes, level: int, out_nbytes_avail: int) -> bytes:
    buf = ctypes.create_string_buffer(out_nbytes_avail)
    n = get_lib().ld_deflate_compress(level, data, len(data), buf, out_nbytes_avail)
    return buf.raw[: int(n)]


def deflate_decompress(
    data: bytes, out_nbytes_avail: int, known_size: bool
) -> tuple[int, bytes | None, int, int]:
    buf = ctypes.create_string_buffer(max(out_nbytes_avail, 1))
    ain = ctypes.c_size_t(0)
    aout = ctypes.c_size_t(0)
    res = get_lib().ld_deflate_decompress(
        data, len(data), buf, out_nbytes_avail,
        1 if known_size else 0, ctypes.byref(ain), ctypes.byref(aout),
    )
    if res != 0:
        return (int(res), None, 0, 0)
    return (0, buf.raw[: aout.value], ain.value, aout.value)
