"""Build the port's _dctcodec CPython extension with g++ + libjpeg.

A copy of ``rgbnomore_tpu/native/build.py`` that writes the ``.so``, its
host tag and its lock into the port's build directory
(``rgbnomore_tpu_torch/_build/``, listed in ``.gitignore``) rather than next
to the source.  Usage: ``python -m rgbnomore_tpu_torch.native.build`` (or it
is invoked automatically on first ``import rgbnomore_tpu_torch.codec``).
"""

from __future__ import annotations

import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "dctcodec.cpp"
BUILD_DIR = HERE.parent / "_build"


def _host_cpu_tag() -> str:
    """A short tag identifying the host CPU's ISA extensions.

    The extension is compiled ``-march=native``; a cached .so carried to a
    different machine (shared volume, container image) could SIGILL.  The
    build records this tag in a sidecar file and rebuilds whenever the tag
    no longer matches the running host.
    """
    import hashlib
    import re

    try:
        text = Path("/proc/cpuinfo").read_text()
        flags = re.search(r"^flags\s*:\s*(.*)$", text, re.M)
        model = re.search(r"^model name\s*:\s*(.*)$", text, re.M)
        key = (model.group(1) if model else "") + "|" + (flags.group(1) if flags else "")
    except OSError:  # non-Linux: fall back to the platform triple
        import platform

        key = platform.processor() + platform.machine()
    return hashlib.sha1(key.encode()).hexdigest()[:10]


def ext_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_dctcodec{suffix}"


def _tag_path() -> Path:
    return BUILD_DIR / "_dctcodec.buildtag"


def _is_fresh(out: Path, tag: str) -> bool:
    return (
        out.exists()
        and out.stat().st_mtime >= SRC.stat().st_mtime
        and _tag_path().exists()
        and _tag_path().read_text().strip() == tag
    )


def build(force: bool = False) -> Path:
    """Compile (if stale) and return the extension path.

    Concurrency-safe: several importers (test workers) can race here.  The
    compile writes to a per-PID temporary and ``os.replace``s it into place
    (atomic on POSIX — no importer ever sees a partially written .so), and an
    ``flock``-held lockfile serializes concurrent builders so g++ runs once.
    """
    import os

    out = ext_path()
    tag = _host_cpu_tag()
    if _is_fresh(out, tag) and not force:
        return out

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lockfile = BUILD_DIR / "_dctcodec.buildlock"
    with open(lockfile, "w") as lf:
        try:
            import fcntl

            fcntl.flock(lf, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: best effort, atomic replace still holds
            pass
        if _is_fresh(out, tag) and not force:  # another process built it
            return out
        include = sysconfig.get_paths()["include"]
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [
            "g++",
            "-O3",
            "-march=native",  # the crop+resize f32 loops need AVX to keep up
            "-funroll-loops",
            "-ffp-contract=fast",
            "-fopenmp-simd",  # `omp simd` pragmas only — no OpenMP runtime dep
            "-std=c++17",
            "-shared",
            "-fPIC",
            f"-I{include}",
            str(SRC),
            "-ljpeg",
            "-o",
            str(tmp),
        ]
        try:
            try:
                subprocess.run(cmd, check=True)
            except subprocess.CalledProcessError:
                cmd.remove("-march=native")  # exotic hosts: portable fallback
                subprocess.run(cmd, check=True)
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
        _tag_path().write_text(tag + "\n")
    return out


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(f"built {path}")
