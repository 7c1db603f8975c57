"""The port's whole-file codec at level 0 (the static tier) against the JAX
package's, and the pinned whole-file digests the card is held to.

``deflate_compress_dp``, ``gzip_compress_dp``, ``zlib_compress_dp`` and
``compress_chunks_dp`` of ``libdeflate_tpu_torch`` on a mesh of eight CPU
devices against ``libdeflate_tpu.parallel`` on the forced 8-device CPU
mesh, on the cases of tests/file_codec_cases.py.  Tolerance: exact.
"""

import json

import pytest

from file_codec_cases import (  # noqa: F401
    CASES,
    REPO,
    check_compress_chunks_dp,
    check_file_codec,
    one_torch_thread,
)

LEVEL = 0
PINS = REPO / "libdeflate_tpu_torch" / "experiments" / "file_codec_pins.json"


def test_compress_chunks_dp_equal():
    check_compress_chunks_dp(LEVEL)


@pytest.mark.parametrize("case", CASES)
def test_file_codec_equal(case):
    check_file_codec(case, LEVEL)


def test_pins_agree_with_the_pinned_total_bits():
    """Each pinned level's gathered sizes are the chunk compressor's pinned
    per-chunk total_bits (BFINAL moves a bit's value, not the count), and
    its gzip length is the header, each chunk's fragment (its device bytes
    or, when longer than a stored fragment, the stored one) and the
    trailer."""
    pins = json.loads(PINS.read_text())
    exp = REPO / "libdeflate_tpu_torch" / "experiments"
    greedy = json.loads((exp / "greedy_total_bits.json").read_text())
    dp = json.loads((exp / "dp_total_bits.json").read_text())
    chunk_bits = {"0": greedy["total_bits"]["static"],
                  "1": greedy["total_bits"]["dyn1"],
                  "6": dp["total_bits"]["level5"],
                  "9": dp["total_bits"]["level8"],
                  "12": dp["total_bits"]["level10"]}
    assert pins["chunk"] == 1 << 20 and pins["command"].endswith(
        "tests/pin_file_codec.py")
    assert sorted(pins["gzip"], key=int) == list(chunk_bits)
    n = 1 << 20
    stored = 5 * -(-n // 65535) + n + 5
    for level, pin in pins["gzip"].items():
        assert pin["all_bits"] == chunk_bits[level], level
        assert len(pin["sha256"]) == 64
        int(pin["sha256"], 16)
        frags = sum((b + 7) // 8 if b // 8 <= stored else stored
                    for b in pin["all_bits"])
        assert pin["bytes"] == 10 + frags + 8, level
