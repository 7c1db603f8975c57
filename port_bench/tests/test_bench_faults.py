"""Whole runs on the CPU, at a size a test run holds, that skip only the
look for a card: sound, they come out correct; with the timed path
broken underneath, or with the cell's control in the program's place,
``correct`` comes out false.  The faults are those the cells can have:
an answer altered where it is produced, half of the batch left out, and
the exchange between cards left out."""

import json
import subprocess
import sys

import pytest
import torch

from libdeflate_tpu_torch.decompress import fsm
from libdeflate_tpu_torch.parallel import file_codec, mesh
from port_bench import run

SMALL = {"chunk_bytes": 65536, "file_bytes": 4 * 65536,
         "piece_bytes": 65536}
CPU = [torch.device("cpu")]
COMPRESS = ["gzip1-1MiB.compress-64MiB", "gzip6-1MiB.compress-64MiB"]
DECODE = "gzip6-1MiB.decompress-128MiB"


def one_run(capsys, workload, devices=CPU, system="port", seed=2**31 + 3):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0"], devices=devices, system=system,
                  sizes=SMALL)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in last)
    return result


@pytest.mark.parametrize("workload", COMPRESS + [DECODE])
def test_a_sound_run_is_correct(capsys, workload):
    r = one_run(capsys, workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1
    assert {"setup_s"} < set(r["metrics"])


def flip_a_fragment_byte(monkeypatch):
    real = file_codec.device_stream_to_bytes

    def altered(words, bits):
        out = bytearray(real(words, bits))
        out[len(out) // 2] ^= 0x10
        return bytes(out)
    monkeypatch.setattr(file_codec, "device_stream_to_bytes", altered)


def drop_half_the_chunks(monkeypatch):
    real = mesh.pad_chunks
    monkeypatch.setattr(mesh, "pad_chunks", lambda *a: (
        lambda b, n, f, k: (b, n, f, k // 2))(*real(*a)))


def lead_shard_only(monkeypatch):
    """The gather without the exchange: every card's part is the lead
    card's."""
    real = mesh._at_once
    monkeypatch.setattr(mesh, "_at_once", lambda m, fn, args: real(
        m, fn, [args[0]] * len(args)))


@pytest.mark.parametrize("fault", [flip_a_fragment_byte, drop_half_the_chunks,
                                   lead_shard_only])
@pytest.mark.parametrize("workload", COMPRESS)
def test_a_broken_compress_path_is_not_correct(capsys, monkeypatch, fault,
                                               workload):
    fault(monkeypatch)
    r = one_run(capsys, workload, devices=CPU * 2)
    assert not r["correct"] and r["failed"] == 1
    assert r["checks"]["wrong_members"]["value"] == 1


def flip_a_decoded_byte(monkeypatch):
    real = fsm.decompress_chunks

    def altered(*a, **k):
        out, lens, consumed, status = real(*a, **k)
        out = out.clone()
        out[0, 100] ^= 1
        return out, lens, consumed, status
    monkeypatch.setattr(fsm, "decompress_chunks", altered)


def decode_half_the_batch(monkeypatch):
    real = fsm.decompress_chunks

    def half(*a, **k):
        out, lens, consumed, status = real(*a, **k)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, lens, consumed, status
    monkeypatch.setattr(fsm, "decompress_chunks", half)


@pytest.mark.parametrize("fault", [flip_a_decoded_byte, decode_half_the_batch,
                                   lead_shard_only])
def test_a_broken_decode_path_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    r = one_run(capsys, DECODE, devices=CPU * 2)
    assert not r["correct"] and r["checks"]["wrong_chunks"]["value"] >= 1


@pytest.mark.parametrize("workload", COMPRESS[1:] + [DECODE])
def test_the_control_is_not_correct(capsys, workload):
    r = one_run(capsys, workload, system="control")
    assert not r["correct"]
    assert max(c["value"] for c in r["checks"].values()) >= 1


def test_a_run_loads_no_jax():
    code = ("import sys, torch\n"
            "from port_bench import run\n"
            "rc = run.main(['--workload', 'gzip1-1MiB.compress-64MiB', "
            "'--seed', '1', '--seconds', '0'], devices=[torch.device('cpu')], "
            f"sizes={SMALL!r})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "libdeflate_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "libdeflate_tpu"}


def test_without_a_card_the_cli_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        DECODE, "--seed", "1", "--seconds", "1"],
                       cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""
