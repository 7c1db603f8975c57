"""libdeflate-gzip-compatible CLI (role parity: programs/gzip.c).

Counterpart of ``libdeflate_tpu/programs/gzip_cli.py``, with its command
line.  Supports: -1..-12 levels, -c (stdout), -d (decompress), -f
(force), -k (keep), -n (no-name; accepted for compatibility), -q
(quiet), -S SUFFIX, -t (test), -V/--version, --tpu (compress on the
device chunk-DP engine, ``parallel/file_codec.gzip_compress_dp``).  The
name --tpu is the JAX program's; here it means the CUDA card, or the
device that ``--device DEV`` names (default CUDA; without CUDA --tpu
raises unless ``--device cpu`` runs the plain versions).  Invoked as
``gunzip`` (argv[0] or
``python -m libdeflate_tpu_torch.programs.gzip_cli gunzip``) it
decompresses by default.  Multi-member streams, ISIZE-hinted output
sizing with doubling-on-INSUFFICIENT_SPACE and the 1032x expansion cap
mirror programs/gzip.c:211-299; metadata restore mirrors :374-380.
"""

from __future__ import annotations

import os
import sys

import libdeflate_tpu_torch as ld

PROG = "libdeflate-tpu-gzip"
MAX_EXPANSION = 1032  # cap from programs/gzip.c:253-259


def msg(quiet: bool, *args) -> None:
    if not quiet:
        print(f"{PROG}:", *args, file=sys.stderr)


def do_compress(data: bytes, level: int, tpu: bool = False,
                device: str | None = None) -> bytes:
    if tpu:
        from ..parallel import file_codec, mesh

        return file_codec.gzip_compress_dp(
            data, mesh.make_chunk_mesh(None if device is None else [device]),
            level=level
        )
    return ld.Compressor(level).gzip_compress(data)


def do_decompress(data: bytes, quiet: bool) -> bytes | None:
    """Multi-member gzip decompress with ISIZE-hint sizing
    (programs/gzip.c:211-299)."""
    d = ld.Decompressor()
    out = bytearray()
    pos = 0
    while pos < len(data):
        member = data[pos:]
        # ISIZE hint from the last 4 bytes of the member region (for
        # multi-member input this is the LAST member's ISIZE, so treat it as
        # a hint only: start from a modest allocation bounded by the
        # expansion cap and grow on INSUFFICIENT_SPACE, like the reference's
        # doubling loop, programs/gzip.c:211-273)
        hint = int.from_bytes(member[-4:], "little") if len(member) >= 4 else 0
        size = max(min(hint, 1 << 24), 64)
        size = min(size, MAX_EXPANSION * max(len(member), 1))
        while True:
            res, buf, ain, aout = d.gzip_decompress(member, size)
            if res == ld.INSUFFICIENT_SPACE:
                if size >= MAX_EXPANSION * len(member):
                    msg(quiet, "inflated more than", MAX_EXPANSION, "times")
                    return None
                size = min(size * 2, MAX_EXPANSION * len(member))
                continue
            if res != ld.SUCCESS:
                msg(quiet, "invalid compressed data")
                return None
            break
        out += buf
        pos += ain
    return bytes(out)


def process_file(path: str, opts) -> int:
    to_stdout = opts["c"]
    decompress = opts["d"]
    suffix = opts["S"]
    quiet = opts["q"]

    if path == "-":
        # compressed output to a terminal is almost always a mistake
        # (programs/gzip.c:430-447): refuse unless forced
        if not decompress and not opts["t"] and not opts["f"] \
                and sys.stdout.isatty():
            msg(quiet, "compressed data not written to a terminal; use -f "
                       "to force, or redirect the output")
            return 1
        data = sys.stdin.buffer.read()
        in_path = None
    else:
        if decompress and not path.endswith(suffix) and not opts["t"]:
            msg(quiet, f"{path}: does not end with {suffix} suffix -- skipping")
            return 1 if not opts["f"] else 0
        if decompress and not opts["t"] and not to_stdout \
                and len(path) == len(suffix):
            msg(quiet, f"{path}: stripping the {suffix} suffix leaves an "
                       "empty name -- skipping")
            return 1
        st = os.lstat(path)
        import stat as _stat
        if not _stat.S_ISREG(st.st_mode):
            # directories, symlinks, devices: skip (programs/gzip.c:305-330)
            kind = "symbolic link" if _stat.S_ISLNK(st.st_mode) else \
                   "directory" if _stat.S_ISDIR(st.st_mode) else "special file"
            msg(quiet, f"{path} is a {kind} -- skipping")
            return 1 if not opts["f"] else 0
        if st.st_nlink > 1 and not opts["k"] and not to_stdout \
                and not opts["t"] and not opts["f"]:
            # the input would be unlinked but other hard links remain
            # (programs/gzip.c:340-355): refuse unless -f or -k
            msg(quiet, f"{path} has {st.st_nlink - 1} other hard link(s) "
                       "-- unchanged (use -f or -k)")
            return 1
        with open(path, "rb") as f:
            data = f.read()
        in_path = path

    if decompress or opts["t"]:
        out = do_decompress(data, quiet)
        if out is None:
            return 1
        if opts["t"]:
            return 0
        out_path = None if to_stdout or in_path is None else in_path[: -len(suffix)]
    else:
        out = do_compress(data, opts["level"], opts.get("tpu", False),
                          opts["device"])
        out_path = None if to_stdout or in_path is None else in_path + suffix

    if out_path is None:
        sys.stdout.buffer.write(out)
    else:
        if os.path.exists(out_path) and not opts["f"]:
            msg(quiet, f"{out_path} already exists; use -f to overwrite")
            return 1
        with open(out_path, "wb") as f:
            f.write(out)
        # metadata restore (programs/gzip.c:374-380)
        st = os.stat(in_path)
        os.utime(out_path, (st.st_atime, st.st_mtime))
        try:
            os.chmod(out_path, st.st_mode)
            os.chown(out_path, st.st_uid, st.st_gid)
        except (PermissionError, OSError):
            pass
        if not opts["k"]:
            os.unlink(in_path)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0]) if argv else PROG
    args = argv[1:]
    if args and args[0] == "gunzip":  # `python -m ... gzip_cli gunzip`
        prog = "gunzip"
        args = args[1:]
    opts = {
        "level": 6, "c": False, "d": "gunzip" in prog, "f": False,
        "tpu": False, "device": None,
        "k": False, "q": False, "t": False, "S": ".gz",
    }
    files: list[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--version" or a == "-V":
            print(f"{PROG} (libdeflate_tpu_torch {ld.__version__})")
            return 0
        if a == "--help" or a == "-h":
            print(__doc__)
            return 0
        if a == "--tpu":
            opts["tpu"] = True
            i += 1
            continue
        if a == "--device":
            if i + 1 >= len(args):
                msg(opts["q"], "--device requires a device argument")
                return 1
            opts["device"] = args[i + 1]
            i += 2
            continue
        if a.startswith("-") and len(a) > 1 and a != "-":
            body = a[1:]
            if body.isdigit():  # -1 .. -12 (multi-digit like the reference)
                opts["level"] = int(body)
                if not 0 <= opts["level"] <= 12:
                    msg(opts["q"], f"invalid level {body}")
                    return 1
                i += 1
                continue
            j = 0
            while j < len(body):
                ch = body[j]
                if ch in "cdfknqt":
                    if ch != "n":  # -n accepted; we never store name/mtime
                        opts[ch] = True
                elif ch == "S":
                    if body[j + 1 :]:
                        opts["S"] = body[j + 1 :]
                    elif i + 1 < len(args):
                        opts["S"] = args[i + 1]
                        i += 1
                    else:
                        msg(opts["q"], "-S requires a suffix argument")
                        return 1
                    if not opts["S"]:
                        msg(opts["q"], "invalid suffix")
                        return 1
                    j = len(body)
                    break
                else:
                    msg(opts["q"], f"unknown option -{ch}")
                    return 1
                j += 1
            i += 1
            continue
        files.append(a)
        i += 1

    if not files:
        files = ["-"]
        opts["c"] = True
    rc = 0
    for f in files:
        try:
            rc |= process_file(f, opts)
        except OSError as e:
            # missing/unreadable/unwritable files: report and continue with
            # the next argument, like programs/gzip.c
            msg(opts["q"], f"{f}: {e.strerror or e}")
            rc |= 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
