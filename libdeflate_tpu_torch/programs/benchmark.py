"""Chunked round-trip benchmark program (role parity: programs/benchmark.c).

Counterpart of ``libdeflate_tpu/programs/benchmark.py``, with its command
line.  Per chunk: timed compress -> timed decompress -> memcmp against
the original (programs/benchmark.c:430-538).  Engines: 'ours' (the host
``Compressor`` and ``Decompressor``), 'ours-tpu' (the device pipeline:
``parallel/file_codec`` to compress, the FSM decoder
``decompress/fsm.py`` to decode), 'ours-pallas' (decode only: the scalar
decoder K3, ``decompress/decode.py``), 'zlib' (CPython zlib as the
reference engine stand-in).  The names are the JAX program's; here
'ours-tpu' and 'ours-pallas' run on the CUDA card, or on the device that
``--device DEV`` names (default CUDA; without CUDA they raise unless
``--device cpu`` runs the plain versions).  Cross-engine runs (-Y/-Z
analogue) are supported by selecting different compress/decompress
engines.

Usage:
  python -m libdeflate_tpu_torch.programs.benchmark [-LEVEL]
      [-s CHUNKSIZE] [-g|-z] [-e] [-C ENGINE] [-D ENGINE] [-p]
      [--device DEV] FILE...
"""

from __future__ import annotations

import sys
import time
import zlib as _zlib

import libdeflate_tpu_torch as ld


def _body(blob: bytes, fmt: str) -> bytes:
    """The raw DEFLATE inside a zlib or gzip wrapper (or blob itself)."""
    from ..formats import gzip_fmt, zlib_fmt

    if fmt == "zlib":
        if zlib_fmt.parse_header(blob) is None:
            raise ValueError("bad zlib header")
        return blob[2:-4]
    if fmt == "gzip":
        hdr = gzip_fmt.parse_header(blob)
        if hdr is None:
            raise ValueError("bad gzip header")
        return blob[hdr:-8]
    return blob


def make_engines(level: int, fmt: str, device: str | None = None):
    comp = {}
    decomp = {}

    c = ld.Compressor(min(max(level, 0), 12))
    d = ld.Decompressor()
    comp["ours"] = lambda data: c.compress(data, fmt)

    _mesh_cache = []

    def _tpu_c(data):
        # device chunk-DP path (levels ladder: static / dynamic / 2-pass)
        from ..parallel import file_codec, mesh

        if not _mesh_cache:
            _mesh_cache.append(mesh.make_chunk_mesh(
                None if device is None else [device]))
        m = _mesh_cache[0]
        fn = {
            "deflate": lambda: file_codec.deflate_compress_dp(
                data, m, level=level
            )[0],
            "zlib": lambda: file_codec.zlib_compress_dp(data, m, level=level),
            "gzip": lambda: file_codec.gzip_compress_dp(data, m, level=level),
        }[fmt]
        return fn()

    comp["ours-tpu"] = _tpu_c
    def _ours_d(blob, out_size):
        res, out, _, _ = d.decompress(blob, out_size, fmt, known_size=True)
        if res != ld.SUCCESS:
            raise ValueError(f"decompress failed: {res}")
        return out
    decomp["ours"] = _ours_d

    def _tpu_d(blob, out_size):
        # the FSM decoder on the device (F1)
        import numpy as np

        from ..decompress import fsm

        body = _body(blob, fmt)
        arr = np.frombuffer(body, np.uint8)[None, :].copy()
        out, lens, _consumed, res = fsm.decompress_chunks(
            arr, np.array([len(body)], np.int32), out_size, device=device
        )
        res = int(res[0])
        if res != 0:
            raise ValueError(f"device decompress failed: {res}")
        return out[0, : int(lens[0])].cpu().numpy().tobytes()

    decomp["ours-tpu"] = _tpu_d

    def _pallas_d(blob, out_size):
        # the scalar decoder (K3, decompress/decode.py)
        from ..decompress import decode

        outs, status = decode.decompress_chunks_host(
            [_body(blob, fmt)], [out_size], device=device
        )
        if status[0] != 0:
            raise ValueError(f"pallas decompress failed: {status[0]}")
        return outs[0]

    decomp["ours-pallas"] = _pallas_d

    zlevel = min(max(level, 0), 9)
    if fmt == "deflate":
        comp["zlib"] = lambda data: (
            lambda o: o.compress(data) + o.flush()
        )(_zlib.compressobj(zlevel, _zlib.DEFLATED, -15))
        decomp["zlib"] = lambda blob, n: _zlib.decompressobj(-15).decompress(blob, n)
    elif fmt == "zlib":
        comp["zlib"] = lambda data: _zlib.compress(data, zlevel)
        decomp["zlib"] = lambda blob, n: _zlib.decompress(blob)
    else:
        comp["zlib"] = lambda data: (
            lambda o: o.compress(data) + o.flush()
        )(_zlib.compressobj(zlevel, _zlib.DEFLATED, 31))
        decomp["zlib"] = lambda blob, n: _zlib.decompress(blob, 31)
    return comp, decomp


def run(path: str, level: int, chunk_size: int, fmt: str,
        comp_engine: str, decomp_engine: str, allow_expansion: bool,
        profile: bool = False, device: str | None = None) -> int:
    from ..utils.profiling import Phase, device_trace

    with open(path, "rb") as f:
        data = f.read()
    comp, decomp = make_engines(level, fmt, device)
    if comp_engine not in comp or decomp_engine not in decomp:
        print(
            f"unknown engine (compress: {sorted(comp)}, "
            f"decompress: {sorted(decomp)})",
            file=sys.stderr,
        )
        return 2
    cfn, dfn = comp[comp_engine], decomp[decomp_engine]

    phases = Phase()
    total_in = total_out = 0
    t_comp = t_dec = 0.0
    with device_trace():
        for off in range(0, len(data), chunk_size):
            chunk = data[off : off + chunk_size]
            t0 = time.perf_counter()
            with phases("compress"):
                blob = cfn(chunk)
            t_comp += time.perf_counter() - t0
            if not allow_expansion and len(blob) >= len(chunk) + 64:
                print(f"chunk at {off} expanded; use -e", file=sys.stderr)
                return 1
            t0 = time.perf_counter()
            with phases("decompress"):
                out = dfn(blob, len(chunk))
            t_dec += time.perf_counter() - t0
            with phases("verify"):
                ok = out == chunk
            if not ok:
                print(f"ROUND-TRIP MISMATCH at offset {off}", file=sys.stderr)
                return 1
            total_in += len(chunk)
            total_out += len(blob)

    print(f'Processing "{path}"...')
    print(f"\tCompressed {total_in} => {total_out} bytes "
          f"({100*total_out/max(total_in,1):.3f}%)")
    if t_comp:
        print(f"\tCompression time: {t_comp*1e3:.0f} ms "
              f"({total_in/t_comp/1e6:.0f} MB/s)")
    if t_dec:
        print(f"\tDecompression time: {t_dec*1e3:.0f} ms "
              f"({total_in/t_dec/1e6:.0f} MB/s)")
    if profile:
        print("\tPhases:")
        phases.report(sys.stdout)
    return 0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    level, chunk_size, fmt = 6, 1 << 20, "deflate"
    comp_engine = decomp_engine = "ours"
    allow_expansion = False
    profile = False
    device = None
    files = []
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and a[1:].isdigit():
            level = int(a[1:])
        elif a == "-s":
            i += 1
            chunk_size = int(args[i])
        elif a == "-g":
            fmt = "gzip"
        elif a == "-z":
            fmt = "zlib"
        elif a == "-e":
            allow_expansion = True
        elif a == "-C":
            i += 1
            comp_engine = args[i]
        elif a == "-D":
            i += 1
            decomp_engine = args[i]
        elif a == "-p" or a == "--profile":
            profile = True
        elif a == "--device":
            i += 1
            device = args[i]
        else:
            files.append(a)
        i += 1
    print("Benchmarking DEFLATE compression:")
    print(f"\tCompression level: {level}")
    print(f"\tChunk size: {chunk_size}")
    print(f"\tCompression engine: {comp_engine}")
    print(f"\tDecompression engine: {decomp_engine}")
    rc = 0
    for f in files:
        rc |= run(f, level, chunk_size, fmt, comp_engine, decomp_engine,
                  allow_expansion, profile, device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
