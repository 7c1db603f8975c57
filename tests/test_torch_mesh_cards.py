"""The whole-file entry over meshes of one, two and four devices (CPU
devices here; one a card on a host of cards): the file goes to the
devices from the calling thread's batch buffer, each shard's results
stay on its own device, and the member does not depend on the mesh.

- A seeded file of 7 MiB and a tail, in 1 MiB chunks: seven of the
  pinned corpus's first chunk (``experiments/corpus.py``, text, kept
  chunks) and a tail of random bytes of a seeded length (a short last
  chunk that takes the stored fallback), through ``gzip_compress_dp`` at
  levels 1 and 6 on ``["cpu"]``, ``["cpu"] * 2`` and ``["cpu"] * 4``:
  the three members are byte-identical, every full chunk's total_bits
  is its corpus chunk's in ``experiments/file_codec_pins.json``, and the
  benchmark's plain reference (``port_bench.reference.gzip_member``)
  passes each.  A chunk's bits depend on that chunk alone
  (tests/test_torch_mesh.py), so in this file the tier entry runs once
  a distinct row (``OnceARow``): a 1 MiB chunk at level 6 takes ~10 s
  of the CPU.
- The batch buffer: allocated once over repeated calls; after a longer
  file a shorter one gives the member a fresh thread gives, and nothing
  of the longer file is left in the last chunk's tail or the padding
  rows.
- ``_compress_dp`` gathers nothing across devices, and
  ``compress_chunks_dp`` still returns the words gathered on the lead
  device.

No JAX call; torch at one intra-op thread.
"""

import json
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from libdeflate_tpu_torch.experiments.corpus import make_corpus
from libdeflate_tpu_torch.parallel import file_codec
from libdeflate_tpu_torch.parallel import mesh as pm
from port_bench.reference import gzip_member

REPO = Path(__file__).resolve().parents[1]
PINS = json.loads((REPO / "libdeflate_tpu_torch" / "experiments"
                   / "file_codec_pins.json").read_text())
CH = 1 << 20
SEED = 2_600_000_011
CHUNK_COMPRESSOR = pm.chunk_compressor      # the mesh's, unpatched
SMALL = 1 << 14


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_file() -> bytes:
    corpus = make_corpus(8 * CH)
    rng = np.random.default_rng(SEED)
    tail = rng.integers(0, 256, int(rng.integers(1, CH)), dtype=np.uint8)
    return corpus[:CH] * 7 + tail.tobytes()


class OnceARow:
    """``chunk_compressor(level)`` that compresses each distinct row
    (bytes, length, BFINAL) once, on the device of the first shard that
    asks, and stacks every batch's rows from those."""

    def __init__(self, level: int):
        self.real = CHUNK_COMPRESSOR(level)
        self.rows: dict = {}
        self.lock = threading.Lock()

    def __call__(self, bufs, lengths, bfinal, device=None):
        keys = [(row.numpy().tobytes(), n, f) for row, n, f in zip(
            bufs, lengths.tolist(), bfinal.tolist())]
        with self.lock:
            todo = list({k: i for i, k in enumerate(keys)
                         if k not in self.rows}.values())
            if todo:
                words, bits = self.real(bufs[todo], lengths[todo],
                                        bfinal[todo], device=device)
                for j, i in enumerate(todo):
                    self.rows[keys[i]] = words[j], bits[j]
            got = [self.rows[k] for k in keys]
        return (torch.stack([w for w, _ in got]),
                torch.stack([b for _, b in got]))


# each level's rows, shared by the tests of this file
ONCE = {level: OnceARow(level) for level in (1, 6)}


@pytest.fixture(autouse=True)
def once_a_row(monkeypatch):
    monkeypatch.setattr(pm, "chunk_compressor", ONCE.__getitem__)


@pytest.mark.parametrize("level", [1, 6])
def test_members_equal_over_one_two_and_four_devices(level, monkeypatch):
    data = seeded_file()
    assert 7 * CH < len(data) < 8 * CH
    real_shards, bits = pm.compress_shards, []

    def noted(*args, **kwargs):
        out = real_shards(*args, **kwargs)
        bits.append(torch.cat([s[1] for s in out]).tolist())
        return out
    monkeypatch.setattr(pm, "compress_shards", noted)
    members = [file_codec.gzip_compress_dp(
        data, pm.make_chunk_mesh(["cpu"] * n), CH, level) for n in (1, 2, 4)]
    assert members[0] == members[1] == members[2]
    crc = zlib.crc32(data)
    for member in members:
        assert gzip_member.check(member, data, crc) is None
        assert not gzip_member.over_bound(member, len(data), CH)
    pin = PINS["gzip"][str(level)]["all_bits"][0]
    assert bits == [[pin] * 7 + bits[0][7:8]] * 3
    # the tail is stored: its slot is the stored fragment
    assert bits[0][7] // 8 > file_codec.stored_fragment_size(len(data)
                                                              - 7 * CH)
    assert sum(k[1] in (CH, len(data) - 7 * CH)
               for k in ONCE[level].rows) == 2


def _batch():
    return file_codec._assembly.batch[False]


@pytest.fixture
def fresh_buffers(monkeypatch):
    """The calling thread starts with no buffers."""
    monkeypatch.setattr(file_codec, "_assembly", threading.local())


def _files():
    rng = np.random.default_rng(SEED + 1)
    text = make_corpus(8 * SMALL)[:5 * SMALL + 999]
    noise = rng.integers(0, 256, 7 * SMALL + 5, dtype=np.uint8).tobytes()
    return noise, text


def _in_a_fresh_thread(fn):
    got = []
    t = threading.Thread(target=lambda: got.append(fn()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(got) == 1
    return got[0]


def test_a_shorter_file_after_a_longer_one_leaves_nothing_behind(
        fresh_buffers):
    mesh = pm.make_chunk_mesh(["cpu"] * 4)
    longer, shorter = _files()

    def compress(data):
        return file_codec.gzip_compress_dp(data, mesh, SMALL, 1)
    file_codec.gzip_compress_dp(longer, mesh, SMALL, 1)
    after = compress(shorter)
    assert after == _in_a_fresh_thread(lambda: compress(shorter))
    assert zlib.decompress(after, 31) == shorter
    # 6 chunks padded to 8 rows: past the file, the rows are zeros
    flat = _batch()[:8 * SMALL].numpy()
    assert flat[:len(shorter)].tobytes() == shorter
    assert not flat[len(shorter):].any()


def test_the_batch_buffer_is_allocated_once(fresh_buffers, monkeypatch):
    mesh = pm.make_chunk_mesh(["cpu"] * 2)
    longer, shorter = _files()
    allocated = []
    real = file_codec._thread_buffer

    def noted(kind, nbytes, pinned):
        before = file_codec._assembly.__dict__.get(kind, {}).get(pinned)
        buf = real(kind, nbytes, pinned)
        if kind == "batch":
            allocated.append(buf is not before)
        return buf
    monkeypatch.setattr(file_codec, "_thread_buffer", noted)
    members = [file_codec.gzip_compress_dp(data, mesh, SMALL, 1)
               for data in (longer, longer, shorter, longer, shorter)]
    assert allocated == [True, False, False, False, False]
    assert members[0] == members[1] == members[3]
    assert members[2] == members[4]
    assert _batch().numel() == 8 * SMALL


def test_the_entry_gathers_nothing_across_devices(monkeypatch):
    gathered = []
    real = pm._gather

    def spy(mesh, outs):
        gathered.append(len(outs))
        return real(mesh, outs)
    monkeypatch.setattr(pm, "_gather", spy)
    _, text = _files()
    for n in (2, 4):
        member = file_codec.gzip_compress_dp(
            text, pm.make_chunk_mesh(["cpu"] * n), SMALL, 1)
        assert zlib.decompress(member, 31) == text
    assert gathered == []

    mesh = pm.make_chunk_mesh(["cpu"] * 4)
    bufs, lengths, bfinal, _ = pm.pad_chunks(text, SMALL, 4)
    words, total_bits, crcs, adlers, all_bits = pm.compress_chunks_dp(
        mesh, bufs, lengths, bfinal, level=1)
    assert gathered == [4]
    shards = pm.compress_shards(mesh, bufs, lengths, bfinal, level=1)
    for got, k in ((words, 0), (total_bits, 1), (crcs, 2), (adlers, 3)):
        assert got.device == mesh.devices[0] and len(got) == len(bufs)
        assert torch.equal(got, torch.cat([s[k] for s in shards]))
    assert torch.equal(all_bits, total_bits)
