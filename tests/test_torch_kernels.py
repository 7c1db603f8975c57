"""The port's kernel wrappers and package boundaries, on the CPU.

libdeflate_tpu_torch/compress/kernels.py against
libdeflate_tpu/compress/tpu_pipeline.py::_group_place (the pack kernel's
plain version, on the generator of
tests/test_pallas_kernels.py::test_pack_kernel_matches_scatter, and on
crafted start words: all of a chunk's groups on one word, start words
within 46 of nwords, sparse ones; B = 1 and 4); CPU
tensors take the plain versions and launch nothing, the decode wrapper
(libdeflate_tpu_torch/decompress/decode.py) included, and the wrappers
reject shapes and types their kernels do not take; without CUDA the
entry points refuse to run unless asked for the CPU, and a missing nvcc
fails the build of every kernel source (and a header change rebuilds the
sources that include it); the loop kernels' wrappers
(compress/scan_kernels.py: C1, the commit FSM, and C2, the code-length
build) take their plain versions on the CPU and are what commit_items
and build_code_lens_pair call; a launch function's ctypes signature is
set once, on its first use; the port and chip_smoke.py import neither JAX
nor the JAX package, nor bench.py or scripts/.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.  Tolerance: exact.
"""

import ast
import contextlib
import ctypes
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdeflate_tpu_torch as lt
from libdeflate_tpu.compress import tpu_pipeline as tp
from libdeflate_tpu_torch import _build
from libdeflate_tpu_torch.compress import kernels, optimal, pipeline
from libdeflate_tpu_torch.decompress import decode

REPO = Path(__file__).resolve().parents[1]


def _pack_generator(seed=1, groups=40):
    rng = np.random.default_rng(seed)
    n = 128 * groups
    nbits = rng.integers(1, 10, n).astype(np.int32)
    values = rng.integers(0, 1 << 31, n).astype(np.uint32) & (
        (np.uint32(1) << nbits.astype(np.uint32)) - 1)
    offs = np.concatenate([[0], np.cumsum(nbits)[:-1]]).astype(np.int32)
    nwords = int((offs[-1] + nbits[-1] + 31) // 32) + 2
    return values, nbits, offs, nwords


@pytest.mark.parametrize("seed,groups", [(1, 40), (2, 7), (3, 64)])
def test_pack_plain_matches_group_place(seed, groups):
    values, nbits, offs, nwords = _pack_generator(seed, groups)
    sbuf_j, gw_j = tp._group_premerge(jnp.asarray(values), jnp.asarray(nbits),
                                      jnp.asarray(offs))
    want = np.asarray(tp._group_place(sbuf_j, gw_j, nwords))
    sbuf = torch.from_numpy(np.asarray(sbuf_j).astype(np.int64))[None]
    gw = torch.from_numpy(np.asarray(gw_j).astype(np.int64))[None]
    kernels.reset_launch_counts()
    got = kernels.pack_groups(sbuf, gw, nwords)
    assert np.array_equal(got[0].numpy(), want.astype(np.int64))
    assert kernels.pack_groups.launches == 0


def _crafted_pack(case, B, m=300, nwords=3000):
    """Start words the gather kernel finds hard, each chunk's bits spread
    over the groups whose windows reach them (chip_smoke's generator)."""
    from chip_smoke import crafted_pack_inputs
    rng = np.random.default_rng(B)
    if case == "one start word":
        gw = np.repeat(rng.integers(0, nwords - 46, (B, 1)), m, 1)
    elif case == "near nwords":
        gw = np.sort(rng.integers(nwords - 46, nwords, (B, m)), 1)
    else:                                       # sparse, gaps of ~10 rows
        gw = np.sort(rng.integers(0, nwords, (B, m)), 1)
    return crafted_pack_inputs(gw, nwords, 46, torch.device("cpu"), B)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("case", ["one start word", "near nwords", "sparse"])
def test_pack_plain_matches_group_place_on_crafted_start_words(case, B):
    sbuf, gw, nwords = _crafted_pack(case, B)
    kernels.reset_launch_counts()
    got = kernels.pack_groups(sbuf, gw, nwords)
    assert got.shape == (B, nwords) and kernels.pack_groups.launches == 0
    for b in range(B):
        want = tp._group_place(jnp.asarray(sbuf[b].numpy().astype(np.uint32)),
                               jnp.asarray(gw[b].numpy().astype(np.int32)),
                               nwords)
        assert np.array_equal(got[b].numpy(),
                              np.asarray(want).astype(np.int64))


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(2)
    B, n_pad, S = 2, 2048, 1024
    t = [torch.from_numpy(rng.integers(lo, hi, (B, n_pad)))
         for lo, hi in [(16, 200), (0, 259), (1, 32769)] * 3
         + [(0, 2), (0, 300), (0, 300)]]
    args = tuple(t[:12])
    lc = torch.from_numpy(optimal.SEED_LC_LEN)
    kernels.reset_launch_counts()
    got = kernels.dp_parse(*args, lc, S)
    want = kernels.dp_parse_plain(*args, lc, S)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.dp_parse.launches == 0
    assert kernels.pack_groups.launches == 0


def test_wrappers_reject_bad_shapes():
    x = torch.zeros(2, 2048, dtype=torch.int64)
    lc = torch.from_numpy(optimal.SEED_LC_LEN)
    with pytest.raises(ValueError):
        kernels.dp_parse(*([x] * 11 + [x[:1]]), lc, 1024)
    with pytest.raises(ValueError):
        kernels.pack_groups(torch.zeros(2, 4, 46, dtype=torch.int64),
                            torch.zeros(2, 5, dtype=torch.int64), 100)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    bufs = np.zeros((1, 4096), np.uint8)
    args = (bufs, np.array([4096]), np.array([True]))
    if torch.cuda.is_available():
        assert lt.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError):
        lt.resolve_device(None)
    with pytest.raises(RuntimeError):
        lt.compress_chunks_lean(*args)
    words, total_bits = lt.compress_chunks_lean(*args, device="cpu")
    assert words.device.type == "cpu" and int(total_bits[0]) > 0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError):
        _build.nvcc_path()


@pytest.mark.parametrize("name", ["dp_parse", "pack_groups",
                                  "decode_chunks", "tokenize_chunks",
                                  "launch_probes", "fsm_decode",
                                  "commit_fsm", "code_lens"])
def test_missing_nvcc_fails_every_build(name, monkeypatch, tmp_path):
    assert name in _build.KERNEL_SOURCES
    assert (_build.SRC_DIR / f"{name}.cu").is_file()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load(name)


class _StandInFunction:
    """A library function that records its calls and every assignment of
    its ctypes signature."""

    def __init__(self):
        self.sets, self.calls = [], 0

    def __setattr__(self, key, value):
        if key in ("argtypes", "restype"):
            self.sets.append(key)
        object.__setattr__(self, key, value)

    def __call__(self, *args):
        self.calls += 1
        return 0


def _stand_in_library(monkeypatch, fn_name):
    fn = _StandInFunction()
    lib = type("Lib", (), {fn_name: fn})()
    loads = []
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "load", lambda n: loads.append(n) or lib)
    return fn, loads


@pytest.mark.parametrize("name,fn_name", [
    ("dp_parse", "dp_parse_launch"),
    ("pack_groups", "pack_groups_launch"),
    ("decode_chunks", "decode_chunks_launch"),
    ("tokenize_chunks", "tokenize_chunks_launch"),
    ("launch_probes", "grid_add_one_launch"),
    ("launch_probes", "loop_add_one_launch"),
    ("commit_fsm", "commit_fsm_launch"),
    ("code_lens", "code_lens_launch"),
])
def test_kernel_signature_is_set_once(name, fn_name, monkeypatch):
    """The second kernel() call returns the same function without loading
    the library or setting the function's ctypes signature again."""
    fn, loads = _stand_in_library(monkeypatch, fn_name)
    sig = [_build.PTR, _build.INT, _build.PTR]
    assert _build.kernel(name, fn_name, sig) is fn
    assert _build.kernel(name, fn_name, sig) is fn
    assert fn.sets == ["argtypes", "restype"] and loads == [name]
    assert fn.argtypes == sig and fn.restype is ctypes.c_int


def test_pack_launch_sets_its_signature_once(monkeypatch):
    """Two bare launches of the pack kernel through its wrapper's launch
    helper: two calls, one signature."""
    fn, _ = _stand_in_library(monkeypatch, "pack_groups_launch")
    monkeypatch.setattr(_build, "launch_context", lambda tensors, what:
                        contextlib.nullcontext(ctypes.c_void_p(0)))
    sbuf = torch.zeros(2, 3, 46, dtype=torch.int64)
    gw = torch.zeros(2, 3, dtype=torch.int64)
    out = torch.empty(2, 50, dtype=torch.int64)
    for _ in range(2):
        kernels.pack_groups_into(sbuf, gw, out)
    assert fn.calls == 2 and fn.sets == ["argtypes", "restype"]
    assert len(fn.argtypes) == 8


def _scan_inputs(which):
    """Small CPU inputs of C1 (the commit FSM) or C2 (the code lengths)."""
    rng = np.random.default_rng(3)
    if which == "commit_fsm":
        return (torch.from_numpy(rng.integers(1, 40, (2, 2048))),
                torch.from_numpy(rng.random((2, 2048)) < 0.6),
                torch.from_numpy(rng.integers(0, 5, (2, 2048))), 512)
    return torch.from_numpy(rng.integers(0, 300, (4, 286))), 16, 15


@pytest.mark.parametrize("which", ["commit_fsm", "code_lens"])
def test_cpu_scan_wrappers_take_plain_versions_and_launch_nothing(which):
    from libdeflate_tpu_torch.compress import scan_kernels
    args = _scan_inputs(which)
    plain = {"commit_fsm": scan_kernels.greedy_commit_merge,
             "code_lens": scan_kernels.build_code_lens}[which]
    scan_kernels.reset_launch_counts()
    got = getattr(scan_kernels, which)(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, plain(*args)))
    assert scan_kernels.commit_fsm.launches == 0
    assert scan_kernels.code_lens.launches == 0


@pytest.mark.parametrize("which", ["commit_fsm", "code_lens"])
def test_compress_stages_call_the_scan_wrappers(which, monkeypatch):
    """commit_items and build_code_lens_pair reach their loops only
    through the wrappers, which launch the kernels on CUDA tensors."""
    from libdeflate_tpu_torch.compress import dynamic, scan_kernels
    calls = []
    orig = getattr(scan_kernels, which)
    monkeypatch.setattr(scan_kernels, which,
                        lambda *a: calls.append(a) or orig(*a))
    if which == "commit_fsm":
        span, is_match, dist, seg = _scan_inputs(which)
        pipeline.commit_items(span, is_match, dist,
                              torch.arange(2048)[None],
                              torch.tensor([2048, 1000]), seg)
    else:
        hist = _scan_inputs(which)[0]
        dynamic.build_code_lens_pair(hist[:2], hist[2:, :30], 16, 15)
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["commit shapes", "commit seg",
                                  "code_lens rank"])
def test_scan_wrappers_reject_bad_shapes(case):
    from libdeflate_tpu_torch.compress import scan_kernels
    span, is_match, dist, seg = _scan_inputs("commit_fsm")
    with pytest.raises(ValueError):
        if case == "commit shapes":
            scan_kernels.commit_fsm(span, is_match[:1], dist, seg)
        elif case == "commit seg":
            scan_kernels.commit_fsm(span, is_match, dist, 1000)
        else:
            scan_kernels.code_lens(torch.zeros(286, dtype=torch.int64), 0,
                                   11)


@pytest.mark.parametrize("which", ["commit_fsm", "code_lens"])
def test_scan_launch_sets_its_signature_once(which, monkeypatch):
    """Two bare launches through each scan wrapper's launch helper: two
    calls, one signature, one argument a C parameter."""
    from libdeflate_tpu_torch.compress import scan_kernels
    fn, _ = _stand_in_library(monkeypatch, f"{which}_launch")
    monkeypatch.setattr(_build, "launch_context", lambda tensors, what:
                        contextlib.nullcontext(ctypes.c_void_p(0)))
    for _ in range(2):
        if which == "commit_fsm":
            span, is_match, dist, seg = _scan_inputs(which)
            scan_kernels.commit_fsm_into(span, is_match, dist, seg,
                                         torch.empty_like(is_match),
                                         torch.empty_like(span))
        else:
            hist, refine, max_len = _scan_inputs(which)
            scan_kernels.code_lens_into(
                hist, refine, max_len, torch.empty_like(hist),
                torch.empty(4, dtype=torch.bool))
    assert fn.calls == 2 and fn.sets == ["argtypes", "restype"]
    assert len(fn.argtypes) == 8


def test_header_change_rebuilds_its_includers(monkeypatch, tmp_path):
    """Built libraries newer than every .cu but older than
    inflate_common.cuh: exactly K3's and K4's sources are rebuilt."""
    import os
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    build = tmp_path / "kernels"
    build.mkdir()
    t = 1_700_000_000
    for name in _build.KERNEL_SOURCES:
        os.utime(src / f"{name}.cu", (t - 10, t - 10))
        (build / f"lib{name}.so").write_bytes(b"")
        os.utime(build / f"lib{name}.so", (t, t))
    os.utime(src / "inflate_common.cuh", (t + 10, t + 10))
    built = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            out.write_bytes(b"")
            built.append(Path(cmd[-1]).stem)

        def communicate(self):
            return "", None

        def poll(self):
            return 0

    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    logs = _build.build()
    assert sorted(built) == sorted(logs) == ["decode_chunks",
                                             "tokenize_chunks"]
    assert _build.build() == {}


def _decode_inputs():
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = b"abcabcabcabd" * 50
    s = c.compress(raw) + c.flush()
    comp = np.zeros((2, 2 * decode.STAGE_W), np.uint32)
    comp[0, :-(-len(s) // 4)] = np.frombuffer(s + b"\0" * (-len(s) % 4),
                                              np.uint32)
    return raw, torch.from_numpy(comp), torch.tensor([len(s), 2]), \
        torch.tensor([len(raw), 0])


def test_cpu_decode_takes_plain_version_and_launches_nothing():
    raw, comp, clen, olen = _decode_inputs()
    decode.reset_launch_counts()
    out, status, out_lens, consumed = lt.decompress_chunks_words(
        comp, clen, olen, 1024, device="cpu")
    assert decode.decompress_chunks_words.launches == 0
    assert out.device.type == "cpu" and out.dtype == torch.uint8
    assert status.tolist() == [0, 1] and out_lens[0] == len(raw)
    assert bytes(out[0, :len(raw)].numpy()) == raw
    assert consumed[0] == clen[0]
    want = decode.decode_chunks_plain(comp.view(torch.int32), clen.int(),
                                      olen.int(), 1024)
    assert all(torch.equal(g, w) for g, w in zip(
        (out, status, out_lens, consumed), want))


@pytest.mark.parametrize("case", ["dtype", "rank", "narrow", "lens",
                                  "out_bytes", "strided"])
def test_decode_wrapper_rejects_bad_inputs(case):
    _, comp, clen, olen = _decode_inputs()
    args = [comp, clen, olen, 1024]
    if case == "dtype":
        args[0] = comp.to(torch.int64)
    elif case == "rank":
        args[0] = comp.reshape(-1)
    elif case == "narrow":
        args[0] = comp[:, :decode.STAGE_W - 1].contiguous()
    elif case == "lens":
        args[1] = clen[:1]
    elif case == "out_bytes":
        args[3] = 1022
    else:
        args[0] = torch.zeros(2 * decode.STAGE_W, 2, dtype=torch.int32).T
    with pytest.raises(ValueError):
        lt.decompress_chunks_words(*args, device="cpu")


def test_decode_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        return
    raw, comp, clen, olen = _decode_inputs()
    bufs = np.zeros((1, 64), np.uint8)
    with pytest.raises(RuntimeError):
        lt.decompress_chunks(bufs, np.array([64]), 64)
    with pytest.raises(RuntimeError):
        lt.decompress_chunks_words(comp, clen, olen, 1024)
    with pytest.raises(RuntimeError):
        lt.decompress_chunks_host([b"\x03\x00"], [0])
    outs, status = lt.decompress_chunks_host([b"\x03\x00"], [0],
                                             device="cpu")
    assert outs == [b""] and status == [0]


def _port_files():
    files = sorted((REPO / "libdeflate_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "libdeflate_tpu", "bench",
                               "scripts"), f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, libdeflate_tpu_torch, chip_smoke; "
            "import libdeflate_tpu_torch.experiments.exp_device_roundup; "
            "import libdeflate_tpu_torch.experiments.soak; "
            "import libdeflate_tpu_torch.experiments.fuzz; "
            "from libdeflate_tpu_torch.experiments import ablate_lean, "
            "exp_checksum_decode, exp_corpus2_breadth, exp_crc_profile, "
            "exp_dp_corpus, exp_match_bias, exp_r5_speed, exp_ratio_gap, "
            "exp_text_gap_diag, probe_prims, profile_lean, profile_opt, "
            "ratio_ab; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libdeflate_tpu', 'bench', 'scripts')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_device_stream_to_bytes_roundtrip_of_a_tiny_chunk():
    import zlib
    data = np.frombuffer(b"abcabcabcabd" * 50, np.uint8)
    words, total_bits = lt.compress_chunks_lean(
        data[None], np.array([data.size]), np.array([True]), device="cpu")
    stream = pipeline.device_stream_to_bytes(words[0], total_bits[0])
    assert zlib.decompress(stream, -15) == data.tobytes()
