#!/usr/bin/env python3
"""Time one family of the port's CUDA kernels against another version of
their sources, on one NVIDIA GPU, at the shapes the main paths give them.

Run from the root of a checkout, on a machine with a card:

    python3 tools/kernel_ab.py --family window --other DIR
    python3 tools/kernel_ab.py --family attention_h16 --other DIR

``DIR`` holds the family's two sources (with any headers they include) of
another version, for example the ``rgbnomore_tpu_torch/csrc`` of an earlier
commit unpacked with ``git archive``, or a copy of this one with a tile
size changed; their C entries must take the arguments of this checkout's.
Both versions are built with ``nvcc`` (the port's flags) and bound through
ctypes in one process.  At each case each version's outputs are held to the
plain PyTorch versions first, then each version's calls are timed with CUDA
events and their device time read by ``torch.profiler``
(``chip_smoke.time_ms``, ``chip_smoke.device_ms``), in the order other,
this, this, other.  Prints one line per case, then one JSON object with
every number.  Exits non-zero without a card.

The families:

- ``window``: ``window_attention_fwd.cu`` and ``window_attention_bwd.cu``
  (#3, #4) at every SwinV2-T window shape of one train step at batch 128
  (forward and backward of every stage, unshifted and shifted) and of one
  eval batch of 256 (the forward); also the sums over a pass (12 calls,
  each block at its own case).
- ``attention_h16``: ``attention_h16_fwd.cu`` and ``attention_h16_bwd.cu``
  (#1 and #2 on half-precision inputs) at ViT-B's (256, 12, 196, 64) and
  ViT-Ti's (256, 3, 196, 64) shapes, in bf16 and fp16, held to
  ``chip_smoke``'s half-precision tolerances.
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


def build_other(family: dict, src_dir: Path, out_dir: Path) -> dict:
    """The other version's libraries, compiled together and bound with this
    checkout's C signatures."""
    from rgbnomore_tpu_torch.ops import cuda_build

    jobs = {}
    for name in family["names"]:
        lib = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(lib),
               str(src_dir / f"{name}.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} of {src_dir} did not build:\n{out}")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = family["argtypes"](name)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, *args) -> None:
    import torch

    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"launch failed: cudaError {err}")


# ------------------------------------------------------------------ window
def window_argtypes(name: str) -> list:
    from rgbnomore_tpu_torch.ops.window_attention import _ENTRIES

    n_ptrs, n_ints = _ENTRIES[name]
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong] + [ctypes.c_int] * n_ints
            + [ctypes.c_void_p])


def window_versions(fns: dict) -> dict:
    """tag -> (forward, backward) on CUDA tensors; the other version's
    backward takes the wrapper's default chunk."""
    import torch

    from rgbnomore_tpu_torch.ops import window_attention as W

    def fwd(q, k, v, bias):
        bw, h, n, d = q.shape
        out = torch.empty_like(q)
        launch(fns["window_attention_fwd"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
               bias.data_ptr(), out.data_ptr(), bw, h, n, d, bias.shape[0])
        return out

    def bwd(q, k, v, bias, g):
        bw, h, n, d = q.shape
        npat = bias.shape[0]
        chunk = W._backward_chunk(bw, h, npat)
        chunks = -(-(bw // npat) // chunk)
        grads = [torch.empty_like(x) for x in (q, k, v, bias)]
        part = torch.empty((npat, chunks, h, n, n), device=q.device)
        launch(fns["window_attention_bwd"], *[x.data_ptr() for x in (q, k, v, bias, g, part,
                                                                       *grads)],
               bw, h, n, d, npat, chunk)
        return grads

    return {"other": (fwd, bwd), "this": (W.window_attention_fwd, W.window_attention_bwd)}


def window_cases(gen, versions: dict):
    import torch

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention_bwd_plain,
        window_attention_plain,
    )

    for pass_name, blocks in window_passes().items():
        for case, _ in blocks:
            q, k, v, g, bias = cs.window_inputs(gen, case)
            want = window_attention_plain(q, k, v, bias)
            wgrads = (window_attention_bwd_plain(q, k, v, bias, g) if pass_name == "train"
                      else None)
            calls = {}
            for tag, (fwd, bwd) in versions.items():
                cs.check(torch.allclose(fwd(q, k, v, bias), want, **cs.WIN_TOL),
                         f"{tag} forward {case} beyond {cs.WIN_TOL}")
                calls[tag] = {"fwd": lambda fwd=fwd: fwd(q, k, v, bias)}
                if wgrads is not None:
                    for a, w in zip(bwd(q, k, v, bias, g), wgrads):
                        cs.check(torch.allclose(a, w, **cs.GRAD_TOL),
                                 f"{tag} backward {case} beyond {cs.GRAD_TOL}")
                    calls[tag]["bwd"] = lambda bwd=bwd: bwd(q, k, v, bias, g)
            del want, wgrads
            yield {"pass": pass_name, "case": list(case)}, calls


def window_passes() -> dict:
    return {"train": cs.window_blocks(cs.SWIN_TRAIN_BATCH),
            "eval": cs.window_blocks(cs.SWIN_EVAL_BATCH)}


def window_summary(rows: list[dict]) -> dict:
    """Per pass, each key's sum over the pass's 12 calls (each block at
    its own case), for the first and second timing of each version."""
    sums = {}
    for pass_name, blocks in window_passes().items():
        by_case = {tuple(r["case"]): r for r in rows if r["pass"] == pass_name}
        for key in [k for k in by_case[blocks[0][0]] if k.endswith("ms")]:
            for i in range(2):
                vals = [by_case[case][key][i] for case, _ in blocks]
                sums.setdefault(f"{pass_name}_{key}", []).append(
                    None if None in vals else sum(nb * x for x, (_, nb) in zip(vals, blocks)))
    for key, vals in sums.items():
        print(f"per pass (12 calls): {key} {' / '.join(cs.ms_text(x) for x in vals)}", flush=True)
    return {"per_pass": sums}


# ----------------------------------------------------------- attention_h16
def h16_argtypes(name: str) -> list:
    from rgbnomore_tpu_torch.ops.attention import _ENTRIES

    return [ctypes.c_void_p] * _ENTRIES[name][0] + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]


def h16_versions(fns: dict) -> dict:
    """tag -> (forward with lse, backward) on CUDA tensors."""
    import torch

    from rgbnomore_tpu_torch.ops import attention as A

    def fwd(q, k, v, scale):
        b, h, n, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, n), device=q.device)
        launch(fns["attention_h16_fwd"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), lse.data_ptr(), b * h, n, d, scale, A._ELEMENT[q.dtype])
        return out, lse

    def bwd(q, k, v, out, lse, g, scale):
        b, h, n, d = q.shape
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        ds = torch.empty((b, h, n, n), device=q.device)
        launch(fns["attention_h16_bwd"], *[x.data_ptr() for x in (q, k, v, out, g, lse, delta,
                                                                    ds, *grads)],
               b * h, n, d, scale, A._ELEMENT[q.dtype])
        return grads

    return {"other": (fwd, bwd),
            "this": (lambda q, k, v, scale: A.fused_attention_h16_fwd(q, k, v, scale, True),
                     A.fused_attention_h16_bwd)}


def h16_cases(gen, versions: dict):
    import torch

    from rgbnomore_tpu_torch.ops.attention import attention_bwd_plain, attention_plain

    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).removeprefix("torch.")
        ftol, gtol = cs.H16_FWD_TOL[name], cs.H16_GRAD_TOL[name]
        for b, h, n, d, scale in ((256, 12, 196, 64, cs.VITB_SCALE),
                                  (256, 3, 196, 64, cs.ATTN_SCALE)):
            q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            with torch.inference_mode():
                want = attention_plain(q, k, v, scale).float()
            wgrads = attention_bwd_plain(q, k, v, g, scale)
            calls = {}
            for tag, (fwd, bwd) in versions.items():
                out, lse = fwd(q, k, v, scale)
                cs.check(torch.allclose(out.float(), want, atol=2 * ftol["atol"],
                                        rtol=2 * ftol["rtol"]),
                         f"{tag} forward {name} {(b, h, n, d)} beyond 2x {ftol}")
                for a, w in zip(bwd(q, k, v, out, lse, g, scale), wgrads):
                    err = float((a.float() - w.float()).abs().max()) / float(w.abs().max())
                    cs.check(err <= 2 * gtol,
                             f"{tag} backward {name} {(b, h, n, d)}: {err} beyond 2x {gtol}")
                calls[tag] = {"fwd": lambda fwd=fwd: fwd(q, k, v, scale),
                              "bwd": lambda bwd=bwd, out=out, lse=lse:
                                  bwd(q, k, v, out, lse, g, scale)}
            del want, wgrads
            yield {"dtype": name, "shape": [b, h, n, d]}, calls


FAMILIES = {
    "window": {"names": ("window_attention_fwd", "window_attention_bwd"),
               "argtypes": window_argtypes, "versions": window_versions,
               "cases": window_cases, "summary": window_summary},
    "attention_h16": {"names": ("attention_h16_fwd", "attention_h16_bwd"),
                      "argtypes": h16_argtypes, "versions": h16_versions,
                      "cases": h16_cases, "summary": lambda rows: {}},
}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", required=True, choices=sorted(FAMILIES))
    parser.add_argument("--other", required=True, type=Path,
                        help="directory with the other version's sources of the family")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_card(), flush=True)
    from rgbnomore_tpu_torch.ops import cuda_build

    family = FAMILIES[args.family]
    cuda_build.build(list(family["names"]))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        versions = family["versions"](build_other(family, args.other.resolve(), Path(tmp)))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for label, calls in family["cases"](gen, versions):
            row = dict(label)
            for tag in ("other", "this", "this", "other"):
                for kind, call in calls[tag].items():
                    row.setdefault(f"{tag}_{kind}_ms", []).append(cs.time_ms(call))
                    row.setdefault(f"{tag}_{kind}_device_ms", []).append(cs.device_ms(call))
            rows.append(row)
            print(f"{' '.join(str(x) for x in label.values())}: " + "; ".join(
                f"{key} {'/'.join(cs.ms_text(x) for x in vals)}" for key, vals in row.items()
                if key.endswith("ms")), flush=True)
    print(json.dumps({"family": args.family, "cases": rows, **family["summary"](rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
