"""Build the port's _dctcodec CPython extension with g++ + libjpeg.

A copy of ``rgbnomore_tpu/native/build.py`` that writes the ``.so``, its
host tag and its lock into the port's build directory
(``rgbnomore_tpu_torch/_build/``, listed in ``.gitignore``) rather than next
to the source.  Usage: ``python -m rgbnomore_tpu_torch.native.build`` (or it
is invoked automatically on first ``import rgbnomore_tpu_torch.codec``).

It needs no libjpeg development files: it compiles against the libjpeg-turbo
2.1.5 headers kept in ``native/include/`` (``JPEG_LIB_VERSION`` 62) and links
the system's ``-ljpeg`` where that links, or else, by its full path and with
an rpath, the version-62 libjpeg-turbo that Pillow bundles
(``pillow.libs/libjpeg-*.so.62*``).  :func:`jpeg_link_args` picks the
library; :func:`compile_extension` builds one variant into any path.
"""

from __future__ import annotations

import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "dctcodec.cpp"
INCLUDE = HERE / "include"  # libjpeg-turbo 2.1.5's headers
BUILD_DIR = HERE.parent / "_build"


def _links(args: list[str]) -> bool:
    """Whether g++ links an empty shared object with ``args``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "/dev/null", *args,
                              "-o", str(Path(tmp) / "probe.so")], capture_output=True)
    return res.returncode == 0


def _pillow_libjpeg() -> Path | None:
    """The version-62 libjpeg that Pillow bundles, if Pillow is installed
    with one (found without importing Pillow)."""
    import importlib.util

    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    libs = sorted((Path(spec.origin).parent.parent / "pillow.libs").glob("libjpeg-*.so.62*"))
    return libs[0] if libs else None


def jpeg_link_args(which: str | None = None) -> list[str]:
    """The linker arguments of a libjpeg: ``which="system"`` (``-ljpeg``),
    ``"pillow"`` (Pillow's bundled copy by its full path, with an rpath to
    its directory), or ``None`` for the system's where it links, else
    Pillow's.  Raises ``RuntimeError`` when the asked-for one is missing."""
    if which in (None, "system") and _links(["-ljpeg"]):
        return ["-ljpeg"]
    if which in (None, "pillow"):
        lib = _pillow_libjpeg()
        if lib is not None:
            return [str(lib), f"-Wl,-rpath,{lib.parent}"]
    raise RuntimeError(f"no libjpeg to link ({which or 'system or pillow'}): the host codec "
                       "needs libjpeg (-ljpeg) or Pillow's bundled libjpeg")


def compile_extension(out: Path, link_args: list[str], native: bool = True) -> None:
    """Compile ``dctcodec.cpp`` against ``native/include/`` and link it with
    ``link_args`` into ``out``; ``native`` adds ``-march=native``.  Raises
    ``subprocess.CalledProcessError`` when g++ fails."""
    include = sysconfig.get_paths()["include"]
    cmd = [
        "g++",
        "-O3",
        *(["-march=native"] if native else []),  # the crop+resize f32 loops need AVX
        "-funroll-loops",
        "-ffp-contract=fast",
        "-fopenmp-simd",  # `omp simd` pragmas only — no OpenMP runtime dep
        "-std=c++17",
        "-shared",
        "-fPIC",
        f"-I{INCLUDE}",
        f"-I{include}",
        str(SRC),
        *link_args,
        "-o",
        str(out),
    ]
    subprocess.run(cmd, check=True)


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
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        link = jpeg_link_args()
        try:
            try:
                compile_extension(tmp, link)
            except subprocess.CalledProcessError:
                compile_extension(tmp, link, native=False)  # exotic hosts: portable fallback
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
        _tag_path().write_text(tag + "\n")
    return out


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(f"built {path}")
