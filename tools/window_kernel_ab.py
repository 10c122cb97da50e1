#!/usr/bin/env python3
"""Time the port's window attention kernels against another version of
their sources, on one NVIDIA GPU, at every SwinV2-T window shape.

Run from the root of a checkout, on a machine with a card:

    python3 tools/window_kernel_ab.py --other DIR

``DIR`` holds ``window_attention_fwd.cu`` and ``window_attention_bwd.cu``
(with any headers they include) of another version, for example the
``rgbnomore_tpu_torch/csrc`` of an earlier commit unpacked with ``git
archive``; their C entries must take the arguments of this checkout's.  Both
versions are built with ``nvcc`` (the port's flags) and bound through ctypes
in one process; at each case of one SwinV2-T train step at batch 128 (the
forward and backward of every stage, unshifted and shifted) and of one eval
batch of 256 (the forward), each version's call is timed with CUDA events
and its device time read by ``torch.profiler`` (``chip_smoke.time_ms``,
``chip_smoke.device_ms``), in the order other, this, this, other.  Each
version's outputs are held to the plain PyTorch versions first.  Prints one
line per case and per pass (12 calls, each block at its own case), then one
JSON object with every number.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

NAMES = ("window_attention_fwd", "window_attention_bwd")


def bind(lib_path: Path, name: str):
    from rgbnomore_tpu_torch.ops.window_attention import _ENTRIES

    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    n_ptrs, n_ints = _ENTRIES[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong] + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_other(src_dir: Path, out_dir: Path) -> dict:
    """The other version's two libraries, compiled together."""
    from rgbnomore_tpu_torch.ops import cuda_build

    jobs = {}
    for name in NAMES:
        lib = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(lib),
               str(src_dir / f"{name}.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} of {src_dir} did not build:\n{out}")
        fns[name] = bind(lib, name)
    return fns


def versions(other_fns: dict) -> dict:
    """name -> (forward, backward) callables on CUDA tensors, each version
    on the current stream; the backward picks the wrapper's default chunk."""
    import torch

    from rgbnomore_tpu_torch.ops import window_attention as W

    def fwd_of(fn):
        def run(q, k, v, bias):
            bw, h, n, d = q.shape
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     bw, h, n, d, bias.shape[0], torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"forward launch failed: cudaError {err}")
            return out
        return run

    def bwd_of(fn):
        def run(q, k, v, bias, g):
            bw, h, n, d = q.shape
            npat = bias.shape[0]
            chunk = W._backward_chunk(bw, h, npat)
            chunks = -(-(bw // npat) // chunk)
            grads = [torch.empty_like(x) for x in (q, k, v, bias)]
            part = torch.empty((npat, chunks, h, n, n), device=q.device)
            ptrs = [x.data_ptr() for x in (q, k, v, bias, g, part, *grads)]
            err = fn(*ptrs, bw, h, n, d, npat, chunk, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"backward launch failed: cudaError {err}")
            return grads
        return run

    return {"other": (fwd_of(other_fns[NAMES[0]]), bwd_of(other_fns[NAMES[1]])),
            "this": (W.window_attention_fwd,
                     lambda q, k, v, bias, g: W.window_attention_bwd(q, k, v, bias, g))}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="directory with the other version's window_attention_{fwd,bwd}.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("window_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_card(), flush=True)
    from rgbnomore_tpu_torch.ops import cuda_build
    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention_bwd_plain,
        window_attention_plain,
    )

    cuda_build.build(list(NAMES))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        fns = versions(build_other(args.other.resolve(), Path(tmp)))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        rows: dict = {}
        passes = {"train": cs.window_blocks(cs.SWIN_TRAIN_BATCH),
                  "eval": cs.window_blocks(cs.SWIN_EVAL_BATCH)}
        for pass_name, blocks in passes.items():
            for case, _ in blocks:
                q, k, v, g, bias = cs.window_inputs(gen, case)
                want = window_attention_plain(q, k, v, bias)
                wgrads = window_attention_bwd_plain(q, k, v, bias, g) if pass_name == "train" else None
                for tag, (fwd, bwd) in fns.items():
                    cs.check(torch.allclose(fwd(q, k, v, bias), want, **cs.WIN_TOL),
                             f"{tag} forward {case} beyond {cs.WIN_TOL}")
                    if wgrads is not None:
                        for a, w in zip(bwd(q, k, v, bias, g), wgrads):
                            cs.check(torch.allclose(a, w, **cs.GRAD_TOL),
                                     f"{tag} backward {case} beyond {cs.GRAD_TOL}")
                del want, wgrads
                row = {}
                for tag in ("other", "this", "this", "other"):
                    fwd, bwd = fns[tag]
                    calls = {"fwd": lambda: fwd(q, k, v, bias)}
                    if pass_name == "train":
                        calls["bwd"] = lambda: bwd(q, k, v, bias, g)
                    for kind, call in calls.items():
                        row.setdefault(f"{tag}_{kind}_ms", []).append(cs.time_ms(call))
                        row.setdefault(f"{tag}_{kind}_device_ms", []).append(cs.device_ms(call))
                rows[(pass_name, case)] = row
                print(f"{pass_name} {case}: " + "; ".join(
                    f"{key} {'/'.join(cs.ms_text(x) for x in vals)}" for key, vals in row.items()),
                    flush=True)
                del q, k, v, g, bias
    sums = {}
    for pass_name, blocks in passes.items():
        for key in rows[(pass_name, blocks[0][0])]:
            for i in range(2):
                vals = [rows[(pass_name, case)][key][i] for case, _ in blocks]
                sums.setdefault(f"{pass_name}_{key}", []).append(
                    None if None in vals else sum(nb * x for x, (_, nb) in zip(vals, blocks)))
    for key, vals in sums.items():
        print(f"per pass (12 calls): {key} {' / '.join(cs.ms_text(x) for x in vals)}", flush=True)
    print(json.dumps({"cases": [{"pass": p, "case": list(c), **r} for (p, c), r in rows.items()],
                      "per_pass": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
