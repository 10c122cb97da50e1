#!/usr/bin/env python3
"""Time one family of the port's CUDA kernels against another version of
their sources, on one NVIDIA GPU, at the shapes the main paths give them.

Run from the root of a checkout, on a machine with a card:

    python3 tools/kernel_ab.py --family window --other DIR
    python3 tools/kernel_ab.py --family window_tiled --other DIR
    python3 tools/kernel_ab.py --family attention_h16 --other DIR
    python3 tools/kernel_ab.py --family attention_h16 --probe NAME [NAME ...]

``DIR`` holds the family's two sources (with any headers they include) of
another version, for example the ``rgbnomore_tpu_torch/csrc`` of an earlier
commit unpacked with ``git archive``, or a copy of this one with a tile
size changed.  The window family's C entries must take the arguments of this
checkout's; the half-precision attention family binds each version by the
parameter names of its own C entries.
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
- ``window_tiled``: ``window_attention_tiled_bwd.cu`` (#4L) at SwinV2-B/w16's
  tiled shapes of one train step at batch 256 (stages 1-3, unshifted and
  shifted), both versions on this checkout's #3L's output and log-sum-exp;
  also the sum over a step's 22 calls.
- ``attention_h16``: ``attention_h16_fwd.cu`` and ``attention_h16_bwd.cu``
  (#1 and #2 on half-precision inputs) at ViT-B's (256, 12, 196, 64) and
  ViT-Ti's (256, 3, 196, 64) shapes, in bf16 and fp16, held to
  ``chip_smoke``'s half-precision tolerances; and in fp16 with a
  loss-scaled output gradient whose dS passes fp16's range in every row of
  every head (``chip_smoke``'s "aligned" case), the backward's range guard
  at its most work, held to the float32 reference.

``--probe`` takes, in place of ``DIR``, copies of this checkout's
attention_h16 sources with a few lines replaced (``H16_PROBES``: a part left
out, a tile size changed), one version each, timed at ViT-B's shape only,
for the kernel the probe changes.  A probe that leaves a part out computes
wrong values, so its outputs are not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def start_build(src_dir: Path, name: str, out_dir: Path):
    """Start compiling ``src_dir/name.cu`` (the port's flags) into
    ``out_dir/lib<name>.so``; returns (library, process)."""
    from rgbnomore_tpu_torch.ops import cuda_build

    lib = out_dir / f"lib{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(lib),
           str(src_dir / f"{name}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind_build(family: dict, name: str, src_dir: Path, job):
    """Wait for a build from ``start_build``, keep its ptxas lines beside the
    library, and bind its C entry ``name`` with the signature of the
    sources it was built from."""
    lib, proc = job
    out, _ = proc.communicate()
    cs.check(proc.returncode == 0, f"{name} of {src_dir} did not build:\n{out}")
    Path(f"{lib}.log").write_text(out)
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = family["argtypes"](name, src_dir)
    fn.restype = ctypes.c_int
    return fn


def start_other(family: dict, src_dir: Path, out_dir: Path) -> dict:
    """Start compiling the other version's libraries, one nvcc each."""
    out_dir.mkdir(parents=True, exist_ok=True)
    return {name: start_build(src_dir, name, out_dir) for name in family["names"]}


def bind_other(family: dict, src_dir: Path, jobs: dict) -> dict:
    """The other version's libraries from ``start_other``, bound with the C
    signatures of its own sources."""
    return {name: bind_build(family, name, src_dir, job) for name, job in jobs.items()}


def launch(fn, *args) -> None:
    import torch

    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"launch failed: cudaError {err}")


# ------------------------------------------------------------------ window
def window_argtypes(name: str, src_dir: Path) -> list:
    from rgbnomore_tpu_torch.ops.window_attention import _ENTRIES

    n_ptrs, n_ints = _ENTRIES[name]
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong] + [ctypes.c_int] * n_ints
            + [ctypes.c_void_p])


def window_versions(fns: dict, src_dir: Path | None = None) -> dict:
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


def window_cases(gen, versions: dict, probe: str | None = None):
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


# ------------------------------------------------------------ window_tiled
def tiled_versions(fns: dict, src_dir: Path | None = None) -> dict:
    """tag -> (None, backward) on CUDA tensors: #4L of each version on this
    checkout's #3L's output and log-sum-exp, at the wrapper's default
    chunk."""
    import torch

    from rgbnomore_tpu_torch.ops import window_attention as W

    def bwd(q, k, v, bias, out, lse, g):
        bw, h, n, d = q.shape
        npat = bias.shape[0]
        chunk = W._tiled_chunk(bw, h, n, npat)
        chunks = -(-(bw // npat) // chunk)
        grads = [torch.empty_like(x) for x in (q, k, v, bias)]
        delta = torch.empty_like(lse)
        part = torch.empty((npat, chunks, h, n, n), device=q.device)
        launch(fns["window_attention_tiled_bwd"],
               *[x.data_ptr() for x in (q, k, v, bias, out, g, lse, delta, part, *grads)],
               bw, h, n, d, npat, chunk)
        return grads

    return {"other": (None, bwd), "this": (None, W.window_attention_tiled_bwd)}


def tiled_cases(gen, versions: dict, probe: str | None = None):
    """SwinV2-B/w16's tiled shapes of one train step at batch 256 (stages
    1-3, unshifted and shifted), each version's four gradients within
    ``TILED_TOL`` of the largest entry of the float32 plain version's."""
    import torch

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention_bwd_plain,
        window_attention_tiled_fwd,
    )

    for case, _ in tiled_blocks():
        q, k, v, g, bias = cs.tiled_inputs(gen, case)
        out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
        want = window_attention_bwd_plain(q, k, v, bias, g)
        calls = {}
        for tag, (_, bwd) in versions.items():
            for name, a, w in zip(("dq", "dk", "dv", "db"), bwd(q, k, v, bias, out, lse, g), want):
                err = float((a - w).abs().max() / w.abs().max())
                cs.check(err < cs.TILED_TOL, f"{tag} {name} {case}: {err:.2e} of the largest "
                         f"entry, beyond {cs.TILED_TOL}")
            calls[tag] = {"bwd": lambda bwd=bwd: bwd(q, k, v, bias, out, lse, g)}
        del want
        yield {"pass": "train", "case": list(case)}, calls


def tiled_blocks() -> list:
    return [(case, nb) for case, nb in cs.swinb_blocks(cs.SWINB_BATCH) if case[2] > cs.WIN_N]


def tiled_summary(rows: list[dict]) -> dict:
    """Each key's sum over one train step's 22 tiled calls, for the first
    and second timing of each version."""
    by_case = {tuple(r["case"]): r for r in rows}
    blocks = tiled_blocks()
    sums = {}
    for key in [k for k in rows[0] if k.endswith("ms")]:
        for i in range(2):
            sums.setdefault(f"train_{key}", []).append(
                sum(nb * by_case[case][key][i] for case, nb in blocks))
    for key, vals in sums.items():
        print(f"per step (22 calls): {key} {' / '.join(cs.ms_text(x) for x in vals)}", flush=True)
    return {"per_step": sums}


# ----------------------------------------------------------- attention_h16
def h16_params(src_dir: Path, name: str) -> list[str]:
    """The parameter names of the C entry ``name`` in ``src_dir/name.cu``.
    The backward's differ between versions (an older one takes float32
    ``delta`` and ``ds`` scratch, a newer one one ``scratch`` buffer), so
    each version is bound, and its scratch made, by its own names."""
    text = (src_dir / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    cs.check(sig is not None, f"no C entry {name} in {src_dir}")
    return [p.split()[-1].lstrip("*") for p in sig.group(1).split(",")]


def h16_argtypes(name: str, params: list[str]) -> list:
    return [ctypes.c_void_p if p not in ("bh", "n", "d", "scale", "element") else
            {"bh": ctypes.c_longlong, "scale": ctypes.c_float}.get(p, ctypes.c_int)
            for p in params]


def h16_versions(fns: dict, params: dict) -> dict:
    """tag -> (forward with lse, backward) on CUDA tensors; the other
    version's scratch is made from its entry's parameter names."""
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
        tensors = {"q": q, "k": k, "v": v, "o": out, "dout": g, "lse": lse,
                   "dq": grads[0], "dk": grads[1], "dv": grads[2],
                   "delta": torch.empty_like(lse),
                   "ds": torch.empty((b, h, n, n), device=q.device),
                   "scratch": torch.empty(b * h * (n * d + 1), device=q.device)}
        ptrs = [tensors[p].data_ptr() for p in params["attention_h16_bwd"]
                if p not in ("bh", "n", "d", "scale", "element", "stream")]
        launch(fns["attention_h16_bwd"], *ptrs, b * h, n, d, scale, A._ELEMENT[q.dtype])
        return grads

    return {"other": (fwd, bwd),
            "this": (lambda q, k, v, scale: A.fused_attention_h16_fwd(q, k, v, scale, True),
                     A.fused_attention_h16_bwd)}


def h16_inputs(gen, shape, dtype, kind: str = "random"):
    """q, k, v, dO of ``shape`` on the card: N(0, 1) ("random"), or
    ``chip_smoke``'s loss-scaled "aligned" fp16 case (dO = 8000 V, q = k =
    1.6 sqrt(64 / D) N(0, 1)), whose dS passes 2^15 in every row."""
    import torch

    x, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    if kind == "random":
        return x.to(dtype), torch.randn(shape, generator=gen, device="cuda").to(dtype), \
            v.to(dtype), g.to(dtype)
    q = (1.6 * (64 / shape[-1]) ** 0.5 * x).to(dtype)
    return q, q.clone(), v.to(dtype), (8000.0 * v.to(dtype).float()).to(dtype)


def h16_cases(gen, versions: dict, probe: str | None = None):
    """Each case's calls of each version, checked first: against the plain
    version in the dtype ("random"), or against the float32 reference
    ("aligned", where the plain fp16 backward overflows).  A probe: ViT-B's
    shape only, the kernel it changes only, its outputs unchecked."""
    import torch

    from rgbnomore_tpu_torch.ops.attention import attention_bwd_plain, attention_plain

    cases = [(dtype, kind, shape) for dtype in (torch.bfloat16, torch.float16)
             for kind in (("random", "aligned") if dtype == torch.float16 else ("random",))
             for shape in ((256, 12, 196, 64), (256, 3, 196, 64))]
    kinds = ("fwd", "bwd")
    if probe is not None:
        cases = [c for c in cases if c[2][1] == 12]
        kinds = (H16_PROBES[probe][0].removesuffix(".cu").removeprefix("attention_h16_"),)
    for dtype, kind, shape in cases:
        name = str(dtype).removeprefix("torch.")
        ftol, gtol = cs.H16_FWD_TOL[name], cs.H16_GRAD_TOL[name]
        # ("aligned" at ViT-B's scale at both shapes, as chip_smoke's)
        scale = cs.VITB_SCALE if shape[1] == 12 or kind == "aligned" else cs.ATTN_SCALE
        q, k, v, g = h16_inputs(gen, shape, dtype, kind)
        with torch.inference_mode():
            want = attention_plain(q, k, v, scale).float()
        wgrads = (attention_bwd_plain(q, k, v, g, scale) if kind == "random" else
                  attention_bwd_plain(q.float(), k.float(), v.float(), g.float(), scale))
        calls = {}
        for tag, (fwd, bwd) in versions.items():
            out, lse = fwd(q, k, v, scale)
            if probe is None or tag == "this":
                cs.check(torch.allclose(out.float(), want, atol=2 * ftol["atol"],
                                        rtol=2 * ftol["rtol"]),
                         f"{tag} forward {name} {shape} beyond 2x {ftol}")
                for a, w in zip(bwd(q, k, v, out, lse, g, scale), wgrads):
                    err = float((a.float() - w.float()).abs().max()) / float(w.abs().max())
                    tol = 2 * gtol if kind == "random" else gtol
                    cs.check(bool(torch.isfinite(a)[torch.isfinite(w.to(dtype))].all())
                             and err <= tol, f"{tag} backward {name} {kind} {shape}: {err} "
                             f"beyond {tol}, or not finite where the reference is")
            calls[tag] = {"fwd": lambda fwd=fwd: fwd(q, k, v, scale),
                          "bwd": lambda bwd=bwd, out=out, lse=lse:
                              bwd(q, k, v, out, lse, g, scale)}
            calls[tag] = {key: calls[tag][key] for key in kinds}
        del want, wgrads
        yield {"dtype": name, "kind": kind, "shape": list(shape)}, calls


# probe -> (kernel source, [(text, replacement, occurrences), ...])
H16_PROBES = {
    # #1h with two blocks an SM (255 registers) where three fit
    "fwd_two_blocks": ("attention_h16_fwd.cu", [(
        "constexpr int kHeadBlocks = 3 * head_smem_bytes<NA, KC>() <= 232448 ? 3 : 2;",
        "constexpr int kHeadBlocks = 2;", 1)]),
    # #2h's parts left out: the softmax and dS arithmetic, the dQ product of
    # each tile but the last, the dV and dK products
    "bwd_no_softmax": ("attention_h16_bwd.cu", [(
        "live ? h16::exp2_ftz(fmaf(sT[4 * j + e], scale_log2, -lse_t[col])) : 0.f;",
        "sT[4 * j + e];", 1)]),
    "bwd_no_dq": ("attention_h16_bwd.cu", [("      if (it > 0) dq_tile(it - 1, kg);\n", "", 1)]),
    "bwd_no_dkdv": ("attention_h16_bwd.cu", [("h16::wgmma_rs<T, 1>(", "if (false) h16::wgmma_rs<T, 1>(",
                                              2)]),
    # #2h with key groups of 256 where 208 hold the head (16 dQ steps, not 13)
    "bwd_256_key_groups": ("attention_h16_bwd.cu", [(
        "  if (n <= 208)\n    return launch<T, 1, 13>", "  if (false)\n    return launch<T, 1, 13>",
        1)]),
    # #2h with 16-query products (fewer registers, more products)
    "bwd_16_query_products": ("attention_h16_bwd.cu", [(
        "  constexpr int kBN = 32;", "  constexpr int kBN = 16;", 1)]),
    # fp16's #2h without its range guard (wrong where dS passes 2^15), and
    # without the pass over the head's dO that bounds dS (its divisor 1)
    "bwd_fp16_no_guard": ("attention_h16_bwd.cu", [(
        "constexpr bool kGuard = std::is_same<T, __half>::value;", "constexpr bool kGuard = false;",
        1)]),
    "bwd_fp16_no_dout_pass": ("attention_h16_bwd.cu", [(
        "          dmax = fmaxf(dmax, row_sq<NA>(dout + head, row, d, vec));\n", "", 1)]),
}


def probe_dir(root: Path, name: str) -> Path:
    """A copy of this checkout's kernel sources with the probe's lines
    replaced."""
    out = root / name
    shutil.copytree(Path(__file__).resolve().parent.parent / "rgbnomore_tpu_torch" / "csrc", out)
    source, subs = H16_PROBES[name]
    text = (out / source).read_text()
    for old, new, count in subs:
        cs.check(text.count(old) == count, f"probe {name}: {old!r} is not in {source} "
                 f"{count} times")
        text = text.replace(old, new)
    (out / source).write_text(text)
    return out


FAMILIES = {
    "window": {"names": ("window_attention_fwd", "window_attention_bwd"),
               "argtypes": window_argtypes, "versions": window_versions,
               "cases": window_cases, "summary": window_summary},
    "window_tiled": {"names": ("window_attention_tiled_bwd",), "argtypes": window_argtypes,
                     "versions": tiled_versions, "cases": tiled_cases,
                     "summary": tiled_summary},
    "attention_h16": {"names": ("attention_h16_fwd", "attention_h16_bwd"),
                      "argtypes": lambda name, src_dir: h16_argtypes(
                          name, h16_params(src_dir, name)),
                      "versions": lambda fns, src_dir: h16_versions(
                          fns, {name: h16_params(src_dir, name) for name in fns}),
                      "cases": h16_cases, "summary": lambda rows: {}},
}


def ptxas_lines(src_dir: Path) -> dict[str, str]:
    """kernel<args> -> "registers, spilled bytes" of the main-path instances
    (D = 64, at most 208 keys a head) in the build logs under ``src_dir``."""
    lines, instance, spills = {}, None, None
    for line in "".join(p.read_text() for p in src_dir.glob("*.log")).splitlines():
        if "Compiling entry function" in line:
            instance = cs.kernel_instance(line.split("'")[1])
        elif "spill stores" in line:
            spills = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and instance and re.search(r",1,13[,>]", instance):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines[instance] = f"{regs} regs, {spills} B spilled"
    return lines


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", required=True, choices=sorted(FAMILIES))
    versus = parser.add_mutually_exclusive_group(required=True)
    versus.add_argument("--other", type=Path,
                        help="directory with the other version's sources of the family")
    versus.add_argument("--probe", nargs="+", choices=sorted(H16_PROBES),
                        help="attention_h16: this checkout's sources with a probe's lines "
                        "replaced, as the other version")
    args = parser.parse_args()
    if args.probe and args.family != "attention_h16":
        parser.error("--probe takes the attention_h16 family")
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
        others = {None: args.other.resolve()} if args.other else {
            name: probe_dir(Path(tmp), name) for name in args.probe}
        # every version's libraries compile at once
        jobs = {probe: start_other(family, src, Path(tmp) / f"build_{probe}")
                for probe, src in others.items()}
        for probe, src in others.items():
            versions = family["versions"](bind_other(family, src, jobs[probe]), src)
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            for label, calls in family["cases"](gen, versions, probe):
                row = ({"probe": probe, "ptxas": ptxas_lines(Path(tmp) / f"build_{probe}")}
                       if probe else {})
                row.update(label)
                for tag in ("other", "this", "this", "other"):
                    for kind, call in calls[tag].items():
                        row.setdefault(f"{tag}_{kind}_ms", []).append(cs.time_ms(call))
                        row.setdefault(f"{tag}_{kind}_device_ms", []).append(cs.device_ms(call))
                rows.append(row)
                print(f"{' '.join(str(x) for x in label.values())}"
                      f"{f' (probe {probe})' if probe else ''}: " + "; ".join(
                          f"{key} {'/'.join(cs.ms_text(x) for x in vals)}"
                          for key, vals in row.items() if key.endswith("ms"))
                      + (f"; {row['ptxas']}" if probe else ""), flush=True)
    print(json.dumps({"family": args.family, "cases": rows, **family["summary"](rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
