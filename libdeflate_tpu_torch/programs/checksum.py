"""Checksum program (role parity: programs/checksum.c).

Counterpart of ``libdeflate_tpu/programs/checksum.py``, with its command
line: CRC-32 (default) or Adler-32 (-A) of files; -t prints timing; -m N
reads with deliberate misalignment; -Z uses CPython zlib as the engine
(the reference's -Z uses libz) for differential checking; -T uses the
device path (``ops/checksums.py``).  The name -T is the JAX program's
(the TPU); here it means the CUDA card, or the device that
``--device DEV`` names (default CUDA; without CUDA -T raises unless
``--device cpu`` runs the plain versions).

Run: ``python -m libdeflate_tpu_torch.programs.checksum [-A] [-T] FILE...``
"""

from __future__ import annotations

import sys
import time
import zlib as _zlib

import numpy as np

import libdeflate_tpu_torch as lt


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    use_adler = False
    use_zlib = False
    use_device = False
    device = None
    timing = False
    misalign = 0
    files = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-A":
            use_adler = True
        elif a == "-Z":
            use_zlib = True
        elif a == "-T":
            use_device = True
        elif a == "-t":
            timing = True
        elif a == "-m":
            i += 1
            misalign = int(args[i])
        elif a == "--device":
            i += 1
            device = args[i]
        else:
            files.append(a)
        i += 1
    if not files:
        files = ["-"]

    for path in files:
        data = sys.stdin.buffer.read() if path == "-" else open(path, "rb").read()
        if misalign:
            # a genuinely misaligned view: checksum the tail of a padded
            # buffer through the buffer protocol (slicing back to bytes
            # would copy to an aligned allocation and test nothing -- the
            # reference's -m points its kernels at base+misalign too,
            # programs/checksum.c)
            padded = np.frombuffer(b"\x00" * misalign + data, np.uint8)
            view = padded[misalign:]
            assert view.ctypes.data % 8 == (padded.ctypes.data + misalign) % 8
            data = view
        t0 = time.perf_counter()
        if use_device:
            from ..device import resolve_device
            from ..ops.checksums import adler32_fixed, crc32_fixed

            dev = resolve_device(device)
            buf = np.frombuffer(data, np.uint8)
            if use_adler:
                v = int(adler32_fixed(buf, len(buf), 1, device=dev))
            else:
                v = int(crc32_fixed(buf, len(buf), 0, device=dev))
        elif use_zlib:
            v = _zlib.adler32(data) if use_adler else _zlib.crc32(data)
        else:
            v = lt.adler32(data) if use_adler else lt.crc32(data)
        dt = time.perf_counter() - t0
        name = "Adler-32" if use_adler else "CRC-32"
        print(f"{v:08x}\t{path}")
        if timing:
            print(
                f"\t{name}: {dt*1e3:.2f} ms ({len(data)/max(dt,1e-9)/1e6:.0f} MB/s)",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
