"""Build the port's CUDA kernels with ``nvcc`` and bind them through ctypes.

Each source under ``rgbnomore_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for ``sm_90a``, into the build directory
``rgbnomore_tpu_torch/_build/`` that ``.gitignore`` lists.  A library's file
name carries a hash of its source, of the headers beside it (``*.cuh``) and
of the flags, so a changed source is never served a stale build.
``build()`` starts one ``nvcc`` per stale source, all at once, and waits for
them together; each call is the span ``rgbnm.kernel_build`` and counts its
libraries in ``rgbnm.kernel.built`` (compiled) and ``rgbnm.kernel.cached``
(found built).

Nothing is compiled or loaded at import time: the first launch of a kernel
builds it (``load``), and ``chip_smoke.py`` builds every kernel up front.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from rgbnomore_tpu_torch.utils import profiling

__all__ = ["KERNELS", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel library name -> its source under csrc/
KERNELS = {
    "attention_fwd": "attention_fwd.cu",
    "attention_bwd": "attention_bwd.cu",
    "attention_h16_fwd": "attention_h16_fwd.cu",
    "attention_h16_bwd": "attention_h16_bwd.cu",
    "augpipe": "augpipe.cu",
    "linear_tf32x3": "linear_tf32x3.cu",
    "window_attention_fwd": "window_attention_fwd.cu",
    "window_attention_bwd": "window_attention_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the .log
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if cuda_home:
        candidates.insert(0, str(Path(cuda_home) / "bin" / "nvcc"))
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    src = (CSRC / KERNELS[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))  # headers
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every stale kernel library in ``names`` (default: all), one
    ``nvcc`` per source started together; return ``{name: library path}``.

    The compiler's output (``-Xptxas -v``) is kept beside each library as
    ``<library>.log``.  Raises ``RuntimeError`` with the output of every
    failed compile.
    """
    names = list(KERNELS) if names is None else list(names)
    with profiling.span("rgbnm.kernel_build"):
        paths = {name: library_path(name) for name in names}
        stale = [name for name in names if not paths[name].exists()]
        jobs = {}
        if stale:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "kernels.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time per checkout
                stale = [name for name in stale if not paths[name].exists()]
                nvcc = _nvcc() if stale else ""
                for name in stale:
                    tmp = paths[name].with_name(paths[name].name + f".tmp{os.getpid()}")
                    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])]
                    jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
                failures = []
                for name, (tmp, proc) in jobs.items():
                    out, _ = proc.communicate()
                    if proc.returncode != 0:
                        failures.append(f"{KERNELS[name]} (nvcc exit {proc.returncode}):\n{out}")
                        tmp.unlink(missing_ok=True)
                        continue
                    os.replace(tmp, paths[name])
                    paths[name].with_name(paths[name].name + ".log").write_text(out)
                if failures:
                    raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    profiling.count("rgbnm.kernel.built", len(jobs))
    profiling.count("rgbnm.kernel.cached", len(names) - len(jobs))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
