"""The port's programs (``libdeflate_tpu_torch/programs/``) against the JAX
package's, on the command lines of ``tests/test_programs.py`` (plus
``--device cpu`` where a device engine runs).

- ``gzip_cli``: output bytes equal the JAX program's at levels 1, 6 and
  12 with both packages on one host backend
  (``experiments/host_contract.on_backend``), and the system ``gunzip``
  reads them; a file round trip, stdin to stdout (as
  ``python -m libdeflate_tpu_torch.programs.gzip_cli``), system gzip
  output, multi-member input, corrupt input and ``-t``; ``--tpu
  --device cpu`` at level 1 equals the port's ``gzip_compress_dp`` and
  inflates through zlib, and ``--tpu`` alone needs CUDA;
- ``benchmark``: the compressed sizes of the ``ours`` and ``zlib``
  engines equal the JAX program's in every format; ``-C ours-tpu -D
  ours-tpu`` and ``-D ours-pallas`` round-trip with ``--device cpu``;
- ``checksum``: its lines equal the JAX program's and zlib's, with -A,
  -m 3 and -Z, and ``-T --device cpu`` (the device path's plain
  versions) equals zlib.

Tolerance: exact.
"""

import functools
import os
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from libdeflate_tpu import native_backend as jnb
from libdeflate_tpu.programs import benchmark as jbench
from libdeflate_tpu.programs import checksum as jck
from libdeflate_tpu.programs import gzip_cli as jgz
from libdeflate_tpu_torch import native_backend as nb
from libdeflate_tpu_torch.experiments import host_contract as hc
from libdeflate_tpu_torch.programs import benchmark as pbench
from libdeflate_tpu_torch.programs import checksum as pck
from libdeflate_tpu_torch.programs import gzip_cli as pgz

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
TEXT = (REPO / "SURVEY.md").read_bytes()
DEV_PAYLOAD = TEXT[:8192]     # one chunk for the device engines on the CPU


def run_port(prog, *args, data=None):
    return subprocess.run(
        [sys.executable, "-m", f"libdeflate_tpu_torch.programs.{prog}",
         *args], input=data, capture_output=True, env=ENV, cwd=REPO)


@functools.lru_cache(maxsize=None)
def dp_gzip() -> bytes:
    """The port's ``gzip_compress_dp`` of DEV_PAYLOAD at level 1, on a
    one-device CPU mesh."""
    return lt.gzip_compress_dp(DEV_PAYLOAD, lt.make_chunk_mesh(["cpu"]),
                               level=1)


def gunzip(path) -> bytes:
    return subprocess.run(["gunzip", "-c", str(path)], capture_output=True,
                          check=True).stdout


# ---- gzip_cli --------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("level", [1, 6, 12])
def test_gzip_cli_bytes_equal_jax(tmp_path, backend, level):
    payload = TEXT[:3000]
    p = tmp_path / "data.txt"
    p.write_bytes(payload)
    gz = tmp_path / "data.txt.gz"
    outs = []
    with hc.on_backend(backend, nb, jnb):
        for prog in (jgz, pgz):
            assert prog.main(["gzip", "-k", f"-{level}", str(p)]) == 0
            outs.append(gz.read_bytes())
            assert gunzip(gz) == payload
            gz.unlink()
    assert outs[1] == outs[0]


def test_gzip_cli_file_round_trip(tmp_path):
    p = tmp_path / "data.txt"
    payload = b"some test data for the cli " * 500
    p.write_bytes(payload)
    assert pgz.main(["gzip", "-k", str(p)]) == 0
    gz = tmp_path / "data.txt.gz"
    assert gz.exists() and p.exists() and gunzip(gz) == payload
    # overwriting the kept source needs -f
    assert pgz.main(["gzip", "-d", str(gz)]) == 1
    assert pgz.main(["gzip", "-d", "-f", str(gz)]) == 0
    assert p.read_bytes() == payload and not gz.exists()
    # system gzip output, and the test mode
    q = tmp_path / "x"
    q.write_bytes(b"made by gnu gzip " * 300)
    subprocess.run(["gzip", str(q)], check=True)
    assert pgz.main(["gzip", "-t", str(q) + ".gz"]) == 0
    assert pgz.main(["gunzip", str(q) + ".gz"]) == 0
    assert q.read_bytes() == b"made by gnu gzip " * 300


def test_gzip_cli_stdin_stdout_multimember_and_corrupt(tmp_path):
    payload = b"stream me please " * 100
    r = run_port("gzip_cli", "-c", "-", data=payload)
    assert r.returncode == 0, r.stderr
    assert zlib.decompress(r.stdout, 31) == payload

    def gz(x):
        o = zlib.compressobj(6, zlib.DEFLATED, 31)
        return o.compress(x) + o.flush()

    mm = tmp_path / "mm.gz"
    mm.write_bytes(gz(b"hello ") + r.stdout + gz(b"world"))
    assert pgz.main(["gzip", "-d", "-k", str(mm)]) == 0
    assert (tmp_path / "mm").read_bytes() == b"hello " + payload + b"world"
    bad = tmp_path / "bad.gz"
    bad.write_bytes(b"\x1f\x8b\x08\x00garbagegarbage")
    assert pgz.main(["gzip", "-q", "-t", str(bad)]) != 0
    assert jgz.main(["gzip", "-q", "-t", str(bad)]) != 0


def test_gzip_cli_device_engine_on_cpu(tmp_path):
    p = tmp_path / "dev.txt"
    p.write_bytes(DEV_PAYLOAD)
    assert pgz.main(["gzip", "-k", "-1", "--tpu", "--device", "cpu",
                     str(p)]) == 0
    got = (tmp_path / "dev.txt.gz").read_bytes()
    assert got == dp_gzip()
    assert zlib.decompress(got, 31) == DEV_PAYLOAD
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pgz.main(["gzip", "-k", "-f", "-1", "--tpu", str(p)])


# ---- benchmark -------------------------------------------------------------

def _sizes(text: str) -> tuple[int, int]:
    m = re.search(r"Compressed (\d+) => (\d+) bytes", text)
    assert m, text
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("extra", [[], ["-g"], ["-z"], ["-C", "zlib"],
                                   ["-D", "zlib"]],
                         ids=["deflate", "gzip", "zlib", "C zlib", "D zlib"])
def test_benchmark_sizes_equal_jax(tmp_path, capsys, extra):
    p = tmp_path / "bench.dat"
    rng = np.random.default_rng(0x1E35A7BD)
    p.write_bytes(rng.integers(97, 105, size=100000, dtype=np.uint8)
                  .tobytes())
    argv = ["-6", "-s", "32768", *extra, str(p)]
    sizes = []
    with hc.on_backend("native", nb, jnb):
        for prog in (jbench, pbench):
            assert prog.main(argv) == 0
            sizes.append(_sizes(capsys.readouterr().out))
    assert sizes[1] == sizes[0] and sizes[0][0] == 100000


def test_benchmark_device_engines_on_cpu(tmp_path, capsys):
    p = tmp_path / "dev.dat"
    p.write_bytes(DEV_PAYLOAD)
    assert pbench.main(["-1", "-s", "8192", "-g", "-C", "ours-tpu", "-D",
                        "ours-tpu", "--device", "cpu", str(p)]) == 0
    assert _sizes(capsys.readouterr().out) == (8192, len(dp_gzip()))
    for fmt in ([], ["-z"]):
        assert pbench.main(["-6", "-s", "4000", *fmt, "-D", "ours-pallas",
                            "--device", "cpu", str(p)]) == 0
        assert _sizes(capsys.readouterr().out)[0] == 8192
    r = run_port("benchmark", "-6", "-s", "4096", "-C", "zlib", "-D", "zlib",
                 str(p))
    assert r.returncode == 0, r.stderr.decode()
    assert jbench.main(["-6", "-s", "4096", "-C", "zlib", "-D", "zlib",
                        str(p)]) == 0
    assert _sizes(r.stdout.decode()) == _sizes(capsys.readouterr().out)


# ---- checksum --------------------------------------------------------------

def test_checksum_lines_equal_jax_and_zlib(tmp_path, capsys):
    p = tmp_path / "c.dat"
    payload = b"checksum me" * 1000
    p.write_bytes(payload)
    want = {False: f"{zlib.crc32(payload):08x}\t{p}\n",
            True: f"{zlib.adler32(payload):08x}\t{p}\n"}
    for args in ([], ["-A"], ["-m", "3"], ["-A", "-m", "3"], ["-Z"],
                 ["-A", "-Z"]):
        lines = []
        for prog in (jck, pck):
            assert prog.main([*args, str(p)]) == 0
            lines.append(capsys.readouterr().out)
        assert lines[1] == lines[0] == want["-A" in args], args
    for args in (["-T"], ["-A", "-T"], ["-T", "-m", "3"]):
        assert pck.main([*args, "--device", "cpu", str(p)]) == 0
        assert capsys.readouterr().out == want["-A" in args], args
    r = run_port("checksum", "-A", str(p))
    assert r.returncode == 0 and r.stdout.decode() == want[True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pck.main(["-T", str(p)])
