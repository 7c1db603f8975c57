"""How the port builds, caches and loads its native host codec.

``libdeflate_tpu_torch/native_backend.py`` compiles the repo's
``native/ldtpu_native.cpp`` (the source the JAX package builds) into
``build/native/`` and never into ``native/``, whose library is the JAX
package's.  These tests check that (in a repo layout of their own under
``tmp_path``), that a newer source or another host's ``.cputag``
rebuilds, that ``LIBDEFLATE_TPU_NATIVE_SO`` picks the library, that
``LIBDEFLATE_TPU_NO_NATIVE`` is honoured at the first load and only there
(as in the JAX package), and that two processes building at once both
load a whole library.  These checks build a small stand-in source with
the same C ABI, so that they take a second and never race the real build
or the JAX package's.
"""

import ctypes
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from libdeflate_tpu_torch import native_backend as nb

REPO = Path(__file__).resolve().parents[1]
MODULE = REPO / "libdeflate_tpu_torch" / "native_backend.py"
STUB = textwrap.dedent("""\
    #include <cstddef>
    #include <cstdint>
    extern "C" {
    uint32_t ld_crc32(uint32_t c, const char *p, size_t n) {
        return 0xC0FFEEu + (uint32_t)n; }
    uint32_t ld_adler32(uint32_t a, const char *p, size_t n) { return 7; }
    size_t ld_deflate_compress(int l, const char *p, size_t n, void *o,
                               size_t m) { return 0; }
    int ld_deflate_decompress(const char *p, size_t n, void *o, size_t m,
                              int k, size_t *ain, size_t *aout) { return 1; }
    }
    """)


def _run(code: str, env: dict | None = None, module: Path = MODULE,
         timeout: int = 120):
    """Run ``code`` in a fresh interpreter that loads ``module`` (the
    port's native_backend.py) by path as ``nb``, with no torch import;
    returns its stdout."""
    prog = ("import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('nb', {str(module)!r})\n"
            "nb = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(nb)\n" + textwrap.dedent(code))
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("LIBDEFLATE_TPU_")}
    full.update(env or {})
    out = subprocess.run([sys.executable, "-c", prog], env=full,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """native_backend pointed at the stand-in source and a build dir in
    tmp_path."""
    src = tmp_path / "stub.cpp"
    src.write_text(STUB)
    so = tmp_path / "build" / "native" / "libldtpu_native.so"
    monkeypatch.setattr(nb, "_SRC", str(src))
    monkeypatch.setattr(nb, "_SO", str(so))
    return src, so


def test_build_goes_to_build_native(tmp_path):
    assert Path(nb._SO) == REPO / "build" / "native" / "libldtpu_native.so"
    assert Path(nb._SRC) == REPO / "native" / "ldtpu_native.cpp"
    # the module in a repo layout of its own, so that nothing races the
    # JAX package's build in native/: the library must land in build/native
    (tmp_path / "libdeflate_tpu_torch").mkdir()
    (tmp_path / "native").mkdir()
    copy = tmp_path / "libdeflate_tpu_torch" / "native_backend.py"
    copy.write_text(MODULE.read_text())
    (tmp_path / "native" / "ldtpu_native.cpp").write_text(STUB)
    out = _run("""
        print(nb.available(), nb._SO, nb.crc32(b'abcd'))
    """, module=copy)
    avail, path, crc = out.split()
    so = tmp_path / "build" / "native" / "libldtpu_native.so"
    assert (avail, Path(path), int(crc)) == ("True", so, 0xC0FFEE + 4)
    assert Path(str(so) + ".cputag").read_text() == nb._cpu_tag()
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [
        "ldtpu_native.cpp"]


def test_newer_source_or_other_cputag_rebuilds(stub):
    src, so = stub
    assert not nb._cached_build_usable()
    assert nb._build() and nb._cached_build_usable()
    assert sorted(p.name for p in so.parent.iterdir()) == [
        so.name, so.name + ".cputag"]
    ino = so.stat().st_ino
    # a source newer than the library
    os.utime(so, ns=(src.stat().st_mtime_ns - 10**9,) * 2)
    assert not nb._cached_build_usable()
    assert nb._build() and nb._cached_build_usable()
    assert so.stat().st_ino != ino
    # a library built on another host
    Path(str(so) + ".cputag").write_text("0123456789abcdef")
    assert not nb._cached_build_usable()
    Path(str(so) + ".cputag").unlink()
    assert not nb._cached_build_usable()
    assert nb._build() and nb._cached_build_usable()


def test_native_so_override_loads_that_library(stub):
    src, so = stub
    assert nb._build()
    out = _run("""
        print(nb.available(), nb.crc32(b'abc'))
    """, env={"LIBDEFLATE_TPU_NATIVE_SO": str(so)})
    assert out.split() == ["True", str(0xC0FFEE + 3)]


def test_no_native_is_read_at_first_load_only():
    out = _run("""
        import os
        print(nb.available())
        os.environ.pop('LIBDEFLATE_TPU_NO_NATIVE')
        print(nb.available())
    """, env={"LIBDEFLATE_TPU_NO_NATIVE": "1"})
    assert out.split() == ["False", "False"]
    out = _run("""
        import os
        print(nb.available())
        os.environ['LIBDEFLATE_TPU_NO_NATIVE'] = '1'
        print(nb.available())
    """, timeout=600)
    assert out.split() == ["True", "True"]


def test_no_native_gives_the_python_path():
    code = ("import libdeflate_tpu_torch as lt; "
            "from libdeflate_tpu_torch import native_backend as nb; "
            "print(nb.available(), "
            "lt.Compressor(6).deflate_compress(b'abcab' * 300).hex())")
    env = {**os.environ, "LIBDEFLATE_TPU_NO_NATIVE": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    from libdeflate_tpu_torch.compress import engine
    from libdeflate_tpu_torch.experiments import host_contract as hc
    with hc.forced_python(nb):
        want = engine.deflate_compress(b"abcab" * 300, 6).hex()
    assert out == ["False", want]


def test_two_processes_building_at_once_load_whole_libraries(stub):
    src, so = stub
    # a larger stand-in, so that the two compiles overlap
    src.write_text(STUB + "".join(
        f"extern \"C\" int pad{i}(int x) {{ return x * {i} + {i * i}; }}\n"
        for i in range(3000)))
    code = textwrap.dedent(f"""\
        import ctypes, importlib.util
        spec = importlib.util.spec_from_file_location('nb', {str(MODULE)!r})
        nb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(nb)
        nb._SRC, nb._SO = {str(src)!r}, {str(so)!r}
        assert nb._build()
        lib = ctypes.CDLL(nb._SO)
        lib.pad2999.restype = ctypes.c_int
        print(lib.pad2999(1), nb.get_lib() is not None)
        """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIBDEFLATE_TPU_")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(2999 + 2999 * 2999), "True"]
    assert sorted(p.name for p in so.parent.iterdir()) == [
        so.name, so.name + ".cputag"]
    lib = ctypes.CDLL(str(so))
    lib.pad7.restype = ctypes.c_int
    assert lib.pad7(2) == 2 * 7 + 49
