#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``rgbnomore_tpu_torch/csrc/``
with ``nvcc`` for ``sm_90a`` and the host JPEG codec with ``g++``, holds each
kernel against its plain PyTorch version on the card, then drives the port's
paths at full width: ViT-Ti evaluation over the cropped DCT wire (K=48
``mask16`` rows, batch 256) through ``Trainer.evaluate`` and its train step
over the K=16 wire (batch 256) through ``Trainer.train_step``; then SwinV2-T
(float32) the same two ways (eval batch 256, train batch 128, 32x32 blocks)
and JPEG files through the host codec and ``DctCroppedLoader`` into the
SwinV2 eval.  It checks that every kernel of each path was launched and
that what comes out is right.

Phases, each raising on failure (the script then exits non-zero):
  1. card: print ``nvidia-smi --query-gpu=name,power.limit`` for the card;
  2. build: compile the kernels, one ``nvcc`` per source, started together,
     and the host codec beside them;
  3. kernels: each kernel (attention forward and backward, the fused flip +
     RandAugment + ToRange stage through its dense entry and through its
     wire reader, window attention forward and backward) against its plain
     version at the main paths' shapes and the JAX package's test shapes,
     then timed with CUDA events beside its plain version, its bound and,
     where one exists, a PyTorch library call.  The
     attention and window attention kernels compute in 3xTF32 on the tensor
     cores: their report adds that bound beside the float32 CUDA cores'
     (``bound_ms`` is the tensor cores', the least time for the work as
     they do it), each bound's share, and their device time without the
     host's launch overhead from ``torch.profiler``; two runs of each
     backward must give the same bits.  The window kernels are timed at
     every SwinV2-T stage, unshifted and shifted, summed over one train
     step and one eval batch, and reported with their ``ptxas`` registers
     and spills;
  4. slice: 512 images through the ViT-Ti ``Trainer.evaluate`` with launch
     counts; the pipeline on the card against the CPU, logits of the kernel
     path against the plain path and against the CPU;
  5. breakdown: the time of each stage of one eval step, and of each kernel
     of one forward (``torch.profiler``);
  6. train: 1 + 20 steps of the ViT-Ti ``Trainer.train_step`` on one
     repeated batch of 256 images (warmup 1, lr 3e-3) with launch counts (1
     wire launch of the input stage, 12 attention forward and 12 attention
     backward launches per step), finite losses and a last loss below the
     first; one step's loss and gradients on the card against the CPU at 8
     images; the time of each stage of a step and of each kernel of one
     step;
  7. swin eval: 512 images of 32x32 blocks through the SwinV2-T
     ``Trainer.evaluate`` (1 wire launch and 12 window-attention launches
     per batch); logits of the kernel path against the plain path and the
     card against the CPU; img/s and the forward's kernels;
  8. codec: 256 JPEGs written by the port's codec through
     ``DctCroppedLoader(mode="full")``: decode held to a closed form, host
     decode img/s per thread count, one batch through the SwinV2 eval;
  9. swin train: 1 + 10 steps of the SwinV2-T ``Trainer.train_step`` at
     batch 128 with drop path (1 wire launch, 12 window forward and 24
     window backward launches per step: each backward is a per-chunk pass
     and the reduction of the bias gradient), finite falling losses, the
     card against the CPU at 4 images, the stages, the kernels and the peak
     memory;
 10. determinism: two SwinV2-T train steps from one state with
     ``cfg.train.deterministic``, in a child process (``--determinism``),
     must leave bit-identical parameters; the same without the flag is
     reported beside it.

On every path the input stage is one launch of the augmentation kernel's
wire reader per eval batch and per train step, with no launch of its dense
entry and no call of the plain unpack.

Every comparison of a SwinV2 first sets the scales of its blocks'
res-post norms, which start at 0 (each block then is the identity and no
attention reaches the logits), to random values.  The model paths are fed
rows that this script writes itself in the ``mask16`` layout of
``DctCroppedLoader`` from seeded synthetic coefficient planes
(``write_rows``; ``tests/test_torch_port_eval.py`` holds it against the
port's pipeline); the codec phase reads real JPEG files.  The last two lines
of standard output are the kernel report and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
BATCH = 256
N_IMAGES = 512
GRID = 28  # ViT-Ti block grid: 28x28 blocks, 14x14 patches of 16 px, 196 tokens
K_EVAL = 48
ATTN_SCALE = 1.0 / math.sqrt(192)  # ViT-Ti: 1/sqrt(emb_size)
ATTN_SHAPES = [(256, 3, 196, 64), (2, 3, 49, 32), (2, 3, 128, 128)]
# the Pallas test's tolerance (tests/test_pallas_attention.py:21-30)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
# (shape, scale) of the backward checks: the main path's, the Pallas
# gradient test's (tests/test_pallas_attention.py:33-50) and the forward's
BWD_CASES = [((256, 3, 196, 64), ATTN_SCALE), ((1, 2, 52, 24), 0.13),
             ((2, 3, 49, 32), ATTN_SCALE), ((2, 3, 128, 128), ATTN_SCALE)]
# the Pallas gradient test's tolerance
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
# the Pallas augmentation test's tolerance on the [-1, 1] output
# (tests/test_pallas_augpipe.py:75-76)
AUG_TOL = dict(atol=2e-6, rtol=0)
K_TRAIN = 16
TRAIN_STEPS = 20  # counted steps of the train phase, after one warm-up step
CPU_GRAD_BATCH = 8
# the loss and gradients on the card against the CPU (measured on an H100:
# 7e-8 and 5e-7), with 20x room for float32 sums in other orders
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest gradient entry in the model
# logits after 12 float32 blocks whose sums run in another order than the
# plain path's (and than the CPU's)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 FLOP/s of the tensor
# cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
# SwinV2-T (generate_config("swinv2", "dct"), float32): 32x32 blocks (256
# px), patch 4 -> 64x64 tokens, windows of 8x8 = 64 tokens, head dim 32
SWIN_GRID = 32
SWIN_EVAL_BATCH = 256
SWIN_TRAIN_BATCH = 128
SWIN_TRAIN_STEPS = 10  # counted steps of the swin train phase, after a warm-up
SWIN_CPU_BATCH = 4
# (windows per image, heads, shifted-block patterns) of the four stages; the
# last stage's 8x8 map is one window, so neither of its blocks shifts
SWIN_STAGES = [(64, 3, 64), (16, 6, 16), (4, 12, 4), (1, 24, None)]
SWIN_BLOCKS_PER_STAGE = (2, 2, 6, 2)
WIN_N, WIN_D = 64, 32
# the Pallas window tests' tolerances (tests/test_pallas_attention.py:97, :120)
WIN_TOL = dict(atol=2e-5, rtol=1e-5)
# (bw, h, n, d, P) of the JAX tests (bw 4 / 8 / 12, two pair patterns = four
# of the port's) checked beside the main path's
WIN_JAX_CASES = [(4, 2, 16, 8, 4), (8, 2, 16, 8, 4), (12, 2, 16, 8, 4)]
N_CODEC = 256  # JPEG files of the codec phase
N_CELL_IMAGES = 16  # of them, constant 16x16 colour cells at quality 100
# kernel library -> {kernel<template args>: "registers, spill bytes"}, from
# the build logs' ptxas lines
PTXAS: dict[str, dict[str, str]] = {}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


# --------------------------------------------------------------- the rows
def synthetic_planes(rng: np.random.Generator, n: int, grid: int):
    """Seeded dequantized coefficient planes: y (n, 1, grid, grid, 8, 8) and
    c (n, 2, grid/2, grid/2, 8, 8) float32, in [-1024, 1016], with a JPEG-like
    fall-off of magnitude with frequency and about one AC in five zero."""
    freq = np.add.outer(np.arange(8), np.arange(8)).astype(np.float32)
    amp = 300.0 / (1.0 + 2.0 * freq)

    def plane(shape):
        x = rng.standard_normal(shape + (8, 8)).astype(np.float32) * amp
        x *= rng.random(shape + (8, 8)) < 0.8
        x[..., 0, 0] = rng.uniform(-1000.0, 1000.0, shape)
        return np.clip(x, -1024.0, 1016.0).astype(np.float32)

    return plane((n, 1, grid, grid)), plane((n, 2, grid // 2, grid // 2))


def pack_mask16(blocks: np.ndarray, k: int):
    """The mask16 wire of ``native/dctcodec.cpp`` (pack_block_topk_mask16_f32)
    for blocks (n, 64) float32: exact int16 DC; the K largest ACs by int8
    magnitude (ties to the lower position) as int8 values in ascending
    position order over a uint8 scale ceil(max|AC|/127); an 8-byte
    little-endian occupancy mask.  Returns (values, mask, scale, dc)."""
    n = blocks.shape[0]
    dc = np.clip(np.rint(blocks[:, 0]), -32768, 32767).astype(np.int16)
    ac = blocks[:, 1:]
    mag = np.abs(ac)
    scale = np.clip(np.ceil(mag.max(axis=1) / np.float32(127)), 1, 255).astype(np.float32)
    inv = (np.float32(1) / scale).astype(np.float32)
    q = np.minimum((mag * inv[:, None] + np.float32(0.5)).astype(np.int32), 127)
    keep = np.zeros(q.shape, bool)
    top = np.argsort(-q, axis=1, kind="stable")[:, :k]
    np.put_along_axis(keep, top, True, axis=1)
    keep &= q > 0
    slot = np.cumsum(keep, axis=1) - 1
    rows, cols = np.nonzero(keep)
    values = np.zeros((n, k), np.int8)
    values[rows, slot[rows, cols]] = np.where(ac[rows, cols] < 0, -q[rows, cols],
                                              q[rows, cols])
    bits = np.zeros((n, 64), bool)
    bits[:, 1:] = keep
    mask = np.packbits(bits.reshape(n, 8, 8), axis=-1, bitorder="little").reshape(n, 8)
    return values, mask, scale.astype(np.uint8), dc


def row_fields(rows: np.ndarray, layout: dict) -> dict[str, np.ndarray]:
    """Writable views of every field of (n, row) uint8 rows in ``layout``
    (``packed_layout``), each (n,) + its per-sample shape, of its dtype."""
    out = {}
    for name, spec in layout.items():
        if name == "row":
            continue
        off, shape, dtype = spec
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[name] = rows[:, off:off + nbytes].view(dtype).reshape((rows.shape[0],) + shape)
    return out


def write_rows(y: np.ndarray, c: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Consolidated (n, row) uint8 rows in ``packed_layout(grid, k,
    "mask16")``, as ``DctCroppedLoader`` writes them, for planes y, c."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    n, grid = y.shape[0], y.shape[2]
    layout = packed_layout(grid, k, "mask16")
    rows = np.zeros((n, layout["row"]), np.uint8)
    f = row_fields(rows, layout)
    for tag, planes in (("y", y), ("c", c)):
        vals, mask, scale, dc = pack_mask16(planes.reshape(-1, 64), k)
        lead = planes.shape[:4]
        f[f"v{tag}"][...] = vals.reshape(lead + (k,))
        f[f"i{tag}"][...] = mask.reshape(lead + (8,))
        f[f"s{tag}"][...] = scale.reshape(lead)
        f[f"d{tag}"][...] = dc.reshape(lead)
    f["quant"][...] = 1
    f["labels"][...] = labels
    f["weights"][...] = 1.0
    return rows


def random_wire_rows(rng: np.random.Generator, n: int, grid: int, k: int,
                     fmt: str = "mask16") -> np.ndarray:
    """(n, row) uint8 rows in ``packed_layout(grid, k, fmt)`` with every
    field drawn at random, beyond what the host packer writes: each block's
    mask sets each of the 64 positions (0 included) with its own
    probability in [0, 0.5), so many blocks hold more set bits than K; the
    values span their type (int8, int16 for mask16w), scales [0, 255], DCs
    [-1500, 1500), mask16q's quant tables [0, 255]."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    layout = packed_layout(grid, k, fmt)
    rows = np.zeros((n, layout["row"]), np.uint8)
    f = row_fields(rows, layout)
    for tag in ("y", "c"):
        vals = f[f"v{tag}"]
        info = np.iinfo(vals.dtype)
        vals[...] = rng.integers(info.min, info.max + 1, vals.shape)
        mask = f[f"i{tag}"]
        density = rng.uniform(0.0, 0.5, mask.shape[:-1] + (1,))
        bits = rng.random(mask.shape[:-1] + (64,)) < density
        mask[...] = np.packbits(bits.reshape(bits.shape[:-1] + (8, 8)), axis=-1,
                                bitorder="little")[..., 0]
        f[f"s{tag}"][...] = rng.integers(0, 256, f[f"s{tag}"].shape)
        f[f"d{tag}"][...] = rng.integers(-1500, 1500, f[f"d{tag}"].shape)
    f["quant"][...] = rng.integers(0, 256, f["quant"].shape) if fmt == "mask16q" else 1
    f["labels"][...] = rng.integers(0, 1000, n)
    f["weights"][...] = 1.0
    return rows


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_ms(fn, reps: int = 10) -> float | None:
    """The device time of one ``fn()``: for each kernel that ``torch.profiler``
    sees over ``reps`` calls after a warm-up, its mean time per launch times
    its launches per call (its count over ``reps``, rounded), summed; the
    host's launch overhead, which ``time_ms`` counts, is left out.  The
    profiler drops a launch now and then on the H100 (8 of 10
    counted), so a plain sum over ``reps`` would read low, and now and then
    sees nothing at all: that window is taken again, up to three times.
    None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window where the profiler saw nothing is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                    for e in prof.key_averages() if e.count and e.self_device_time_total > 0)
        if total:
            return total / 1e3
    return None


def product_bounds_ms(flop: float, nbytes: float) -> dict:
    """The least times, in ms, of a kernel that does ``flop`` float32 FLOP
    of matrix products and moves ``nbytes``: ``f32`` with the products on
    the CUDA cores, ``tc`` with them in 3xTF32 on the tensor cores (three
    TF32 products per float32 product), each against the bytes; each with
    what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {}
    for tag, t_ops in (("f32", flop / PEAK_F32_FLOP_PER_S),
                       ("tc", 3 * flop / PEAK_TF32_FLOP_PER_S)):
        out[tag] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")
    return out


def attention_bound_ms(b: int, h: int, n: int, d: int) -> dict:
    """Least times for softmax(QKᵀ)V on the card (``product_bounds_ms``):
    q, k, v read and o written once in float32, against 4*N^2*D*B*H FLOP
    (QKᵀ and PV)."""
    return product_bounds_ms(4 * n * n * d * b * h, 4 * b * h * n * d * 4)


def product_kernel_entry(ms: float, bounds: dict) -> dict:
    """The bound keys of a kernel that computes its products in 3xTF32:
    ``bound_ms`` is the least time for the work as it does it (the tensor
    cores' bound), ``bound_f32_ms`` the bound of float32 CUDA cores beside
    it, each with its share of ``ms``."""
    (tc, tc_by), (f32, f32_by) = bounds["tc"], bounds["f32"]
    return {"bound_ms": tc, "bound_by": tc_by, "bound_tc_ms": tc, "bound_f32_ms": f32,
            "bound_f32_by": f32_by, "bound_share": tc / ms, "bound_f32_share": f32 / ms}


# ---------------------------------------------------------------- phases
def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi listed no card")
    return out[0]


def phase_build() -> None:
    """The kernels (one ``nvcc`` per source, all at once) and, beside them,
    the host codec against the port's own libjpeg headers."""
    from rgbnomore_tpu_torch.native import build as codec_build
    from rgbnomore_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    codec = {}
    worker = threading.Thread(target=lambda: codec.update(path=codec_build.build()))
    worker.start()
    paths = cuda_build.build()
    kernels_s = time.perf_counter() - t0
    worker.join()
    check("path" in codec, "the host codec did not build")
    print(f"build: {len(paths)} kernel libraries in {kernels_s:.1f} s; host codec "
          f"{codec['path'].name} linked with {codec_build.jpeg_link_args()}, both in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in paths.items():
        # one "template args: registers, spill bytes" entry per compiled kernel
        entries, args = {}, "?"
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)", line)
                args = (kernel.group(1) if kernel else line.split("'")[1]) + "<" + ",".join(
                    re.findall(r"Li(\d+)E", line)) + ">"
            elif "spill stores" in line:
                spills = re.findall(r"(\d+) bytes spill", line)
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                entries[args] = f"{regs} regs, spills {'/'.join(spills)} B"
        PTXAS[name] = entries
        print(f"build: {name}: " + "; ".join(f"{k} {v}" for k, v in entries.items()), flush=True)


def kernel_attention_fwd(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import attention_plain, fused_attention

    max_err = 0.0
    with torch.inference_mode():
        for shape in ATTN_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
            got = fused_attention(q, k, v, ATTN_SCALE)
            want = attention_plain(q, k, v, ATTN_SCALE)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(got, want, **ATTN_TOL),
                  f"fused_attention {shape}: max abs err {err} beyond {ATTN_TOL}")
            print(f"kernels: fused_attention {shape} max abs err {err:.3e}", flush=True)
        b, h, n, d = ATTN_SHAPES[0]
        q, k, v = (torch.randn(ATTN_SHAPES[0], generator=gen, device="cuda") for _ in range(3))
        ms = time_ms(lambda: fused_attention(q, k, v, ATTN_SCALE))
        plain_ms = time_ms(lambda: attention_plain(q, k, v, ATTN_SCALE))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=ATTN_SCALE))
        dev_ms = device_ms(lambda: fused_attention(q, k, v, ATTN_SCALE))
        dev_library_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=ATTN_SCALE))
    bounds = product_kernel_entry(ms, attention_bound_ms(b, h, n, d))
    print(f"kernels: fused_attention {ATTN_SHAPES[0]} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms; device time {ms_text(dev_ms)}, sdpa's "
          f"{ms_text(dev_library_ms)}; "
          f"bound 3xTF32 {bounds['bound_tc_ms']:.4f} ms "
          f"({bounds['bound_by']}, {100 * bounds['bound_share']:.1f}% of it), float32 "
          f"{bounds['bound_f32_ms']:.4f} ms ({bounds['bound_f32_by']}, "
          f"{100 * bounds['bound_f32_share']:.1f}%)", flush=True)
    return {
        "name": "fused_attention", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:39",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        **bounds, "library_ms": library_ms, "device_ms": dev_ms,
        "library_device_ms": dev_library_ms,
    }


def kernel_attention_bwd(gen) -> dict:
    """The backward kernel's gradients (through ``fused_attention``'s
    autograd Function) against autograd through ``attention_plain``; then
    the backward alone timed beside the plain backward and SDPA's, each
    from a forward already taken."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import (
        attention_bwd_plain,
        attention_plain,
        fused_attention,
        fused_attention_bwd,
        fused_attention_fwd,
    )

    max_err = 0.0
    for shape, scale in BWD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fused_attention(*leaves, scale).backward(g)
        want = attention_bwd_plain(q, k, v, g, scale)
        torch.cuda.synchronize()
        for tag, leaf, w in zip("qkv", leaves, want):
            err = float((leaf.grad - w).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(leaf.grad, w, **GRAD_TOL),
                  f"fused_attention_bwd {shape} d{tag}: max abs err {err} beyond {GRAD_TOL}")
        print(f"kernels: fused_attention_bwd {shape} scale {scale:.4f} max abs err "
              f"{max_err:.3e}", flush=True)
    b, h, n, d = BWD_CASES[0][0]
    q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda") for _ in range(4))
    out, lse = fused_attention_fwd(q, k, v, ATTN_SCALE, with_lse=True)
    # every sum runs in a fixed order: two runs give the same bits
    first = fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE)
    again = fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE)
    for tag, a, b_ in zip("qkv", first, again):
        check(torch.equal(a, b_), f"fused_attention_bwd {(b, h, n, d)} d{tag} differs between runs")
    print(f"kernels: fused_attention_bwd {(b, h, n, d)}: two runs bit-identical", flush=True)
    del first, again
    ms = time_ms(lambda: fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = attention_plain(*leaves, ATTN_SCALE)
    plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True),
                       reps=10, warmup=2)
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=ATTN_SCALE)
    library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    dev_ms = device_ms(lambda: fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE))
    dev_library_ms = device_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    # the five products of the VJP; q, k, v, out, dout and lse read once,
    # dq, dk, dv written once
    bounds = product_kernel_entry(ms, product_bounds_ms(
        10 * n * n * d * b * h, (8 * q.numel() + lse.numel()) * 4))
    print(f"kernels: fused_attention_bwd {(b, h, n, d)} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms; device time {ms_text(dev_ms)}, sdpa backward's "
          f"{ms_text(dev_library_ms)}; bound 3xTF32 {bounds['bound_tc_ms']:.4f} ms "
          f"({bounds['bound_by']}, {100 * bounds['bound_share']:.1f}% of it), float32 "
          f"{bounds['bound_f32_ms']:.4f} ms ({bounds['bound_f32_by']}, "
          f"{100 * bounds['bound_f32_share']:.1f}%)", flush=True)
    return {
        "name": "fused_attention_bwd", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:51",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        **bounds, "library_ms": library_ms, "device_ms": dev_ms,
        "library_device_ms": dev_library_ms,
    }


def kernel_augpipe() -> dict:
    """The fused flip + RandAugment + ToRange kernel against its plain
    version: each of the 16 ops forced with the explicit policy and flip of
    ``tests/test_pallas_augpipe.py:56-76`` at its shape, policies drawn
    from AUGLIST_DCT at SwinV2-T's (128, 32x32) and from both presets at the
    ViT-Ti's (256, 28x28); then timed at the ViT-Ti's and SwinV2-T's."""
    import torch

    from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
    from rgbnomore_tpu_torch.ops.augpipe import (
        SUPPORTED_OPS,
        flip_aug_range_plain,
        fused_flip_aug_range,
    )
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI

    rng = np.random.default_rng(SEED)

    def coeffs(b, grid):
        """Uniform in [-1100, 1100], beyond the clamp range, as the Pallas test."""
        y = rng.uniform(-1100, 1100, (b, 1, grid, grid, 8, 8)).astype(np.float32)
        c = rng.uniform(-1100, 1100, (b, 2, grid // 2, grid // 2, 8, 8)).astype(np.float32)
        return torch.from_numpy(y).cuda(), torch.from_numpy(c).cuda()

    def compare(tag, y, c, policy, flip, **kw):
        gy, gc = fused_flip_aug_range(y, c, policy, flip, **kw)
        wy, wc = flip_aug_range_plain(y, c, policy, flip, **kw)
        torch.cuda.synchronize()
        err = max(float((gy - wy).abs().max()), float((gc - wc).abs().max()))
        check(torch.allclose(gy, wy, **AUG_TOL) and torch.allclose(gc, wc, **AUG_TOL),
              f"fused_flip_aug_range {tag}: max abs err {err} beyond {AUG_TOL}")
        return err

    forced = (torch.zeros((3, 1), dtype=torch.int32), torch.tensor([[1.0], [-1.0], [1.0]]),
              torch.tensor([[4], [0], [10]], dtype=torch.int32),
              torch.tensor([[6], [2], [0]], dtype=torch.int32),
              torch.tensor([[True], [False], [True]]))
    forced_flip = torch.tensor([False, True, False])
    y, c = coeffs(3, 12)
    max_err = max(compare(name, y, c, forced, forced_flip, ops_list=[name], num_ops=1,
                          magnitude=5) for name in sorted(SUPPORTED_OPS))
    print(f"kernels: fused_flip_aug_range, each of {len(SUPPORTED_OPS)} ops forced at "
          f"(3, 12x12): max abs err {max_err:.3e}", flush=True)
    gen = torch.Generator().manual_seed(SEED)
    for tag, auglist, batch, grid in (
            ("AUGLIST_DCT", AUGLIST_DCT, SWIN_TRAIN_BATCH, SWIN_GRID),
            ("AUGLIST_DCT", AUGLIST_DCT, BATCH, GRID),
            ("AUGLIST_DCT_VITTI", AUGLIST_DCT_VITTI, BATCH, GRID)):
        aug = RandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=grid)
        policy = aug.draw_policy(gen, batch, grid, grid)
        flip = torch.rand(batch, generator=gen) < 0.5
        y, c = coeffs(batch, grid)
        kw = dict(ops_list=list(auglist), num_ops=2, magnitude=3)
        err = compare(tag, y, c, policy, flip, **kw)
        max_err = max(max_err, err)
        print(f"kernels: fused_flip_aug_range {tag} drawn at ({batch}, {grid}x{grid}): max abs "
              f"err {err:.3e}", flush=True)
        if grid == SWIN_GRID:
            policy_d, flip_d = tuple(p.cuda() for p in policy), flip.cuda()
            swin_ms = time_ms(lambda: fused_flip_aug_range(y, c, policy_d, flip_d, **kw))
            print(f"kernels: fused_flip_aug_range ({batch}, {grid}x{grid}) {swin_ms:.4f} ms",
                  flush=True)
    # timed with the last (the ViT-Ti) policy already on the card
    policy, flip = tuple(p.cuda() for p in policy), flip.cuda()
    ms = time_ms(lambda: fused_flip_aug_range(y, c, policy, flip, **kw))
    dev_ms = device_ms(lambda: fused_flip_aug_range(y, c, policy, flip, **kw))
    plain_ms = time_ms(lambda: flip_aug_range_plain(y, c, policy, flip, **kw), reps=10, warmup=2)
    # y and c read once and written once; per coefficient the entry clamp,
    # a multiply and a clamp per round and ToRange's multiply-add
    elements = y.numel() + c.numel()
    t_bytes = 2 * elements * 4 / PEAK_BYTES_PER_S
    t_ops = elements * (4 + 3 * kw["num_ops"]) / PEAK_F32_FLOP_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    print(f"kernels: fused_flip_aug_range ({BATCH}, {GRID}x{GRID}) {ms:.4f} ms (device "
          f"{ms_text(dev_ms)}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.1f}%), no library call", flush=True)
    return {
        "name": "fused_flip_aug_range", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/augpipe.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/augpipe.py:345",
        "entry": "the dense reader (augpipe_fwd): the TPU kernel's own contract; the main "
                 "paths launch the same kernel's wire reader (augpipe_wire)",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "device_ms": dev_ms,
    }


def wire_read_bytes(rows: np.ndarray, grid: int, k: int, fmt: str) -> int:
    """The wire bytes that a stage must read for these rows: per block its
    8-byte mask, its scale, its int16 DC and the values of its first
    min(set bits, K) slots; per sample mask16q's quant tables."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    f = row_fields(rows, packed_layout(grid, k, fmt))
    value_bytes = 2 if fmt == "mask16w" else 1
    total = 3 * 64 * 2 * rows.shape[0] if fmt == "mask16q" else 0
    for tag in ("y", "c"):
        set_bits = np.unpackbits(f[f"i{tag}"], axis=-1).sum(axis=-1)
        total += set_bits.size * (8 + 1 + 2) + int(np.minimum(set_bits, k).sum()) * value_bytes
    return total


def kernel_augpipe_wire() -> dict:
    """The same kernel's wire reader (``wire_flip_aug_range`` for the train
    stage, ``wire_to_range`` for eval) against its plain version (split ->
    unpack -> flip + RandAugment + ToRange, or -> ToRange): each of the 16
    ops forced at (3, 12x12) for each wire format, rows random beyond what
    the packer writes (``random_wire_rows``); then at the four shapes of the
    main paths on rows that ``write_rows`` packs from synthetic planes, as
    the slice and train phases feed them: the ViT-Ti train stage (256,
    28x28, K=16; both presets drawn), SwinV2-T's (128, 32x32, K=16), the
    ViT-Ti eval stage (256, 28x28, K=48) and SwinV2-T's (256, 32x32, K=48);
    train within AUG_TOL, eval bit-exact (``torch.equal``); random rows of
    each format at the ViT-Ti shapes besides.  Each main shape is timed
    beside the plain version, with its device time and its bytes bound: the
    wire bytes its rows need (``wire_read_bytes``) read once and the dense
    float32 planes written once."""
    import torch

    from rgbnomore_tpu_torch.augment.pipeline import make_cropped_train_pipeline
    from rgbnomore_tpu_torch.ops.augpipe import (
        SUPPORTED_OPS,
        WIRE_FORMATS,
        wire_flip_aug_range,
        wire_flip_aug_range_plain,
        wire_to_range,
        wire_to_range_plain,
    )
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI

    rng = np.random.default_rng(SEED + 5)

    def held(tag, rows, flip=None, policy=None, **kw):
        """Max abs err of the kernel against its plain version on ``rows``."""
        packed = torch.from_numpy(rows).cuda()
        if policy is None:
            got, want = wire_to_range(packed, **kw), wire_to_range_plain(packed, **kw)
        else:
            got = wire_flip_aug_range(packed, flip, policy, **kw)
            want = wire_flip_aug_range_plain(packed, flip, policy, **kw)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if policy is None:
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"wire_to_range {tag}: max abs err {err}, not bit-exact")
        else:
            check(all(torch.allclose(g, w, **AUG_TOL) for g, w in zip(got, want)),
                  f"wire_flip_aug_range {tag}: max abs err {err} beyond {AUG_TOL}")
        return err

    forced = (torch.zeros((3, 1), dtype=torch.int32), torch.tensor([[1.0], [-1.0], [1.0]]),
              torch.tensor([[4], [0], [10]], dtype=torch.int32),
              torch.tensor([[6], [2], [0]], dtype=torch.int32),
              torch.tensor([[True], [False], [True]]))
    forced_flip = torch.tensor([False, True, False])
    max_err = 0.0
    for fmt in WIRE_FORMATS:
        rows = random_wire_rows(rng, 3, 12, K_TRAIN, fmt)
        err = max(held(f"{name} {fmt}", rows, forced_flip, forced, target=12, k=K_TRAIN, fmt=fmt,
                       ops_list=[name], num_ops=1, magnitude=5) for name in sorted(SUPPORTED_OPS))
        max_err = max(max_err, err)
        print(f"kernels: wire_flip_aug_range {fmt}, each of {len(SUPPORTED_OPS)} ops forced at "
              f"(3, 12x12): max abs err {err:.3e}", flush=True)
    gen = torch.Generator().manual_seed(SEED)
    vit_pipe = make_cropped_train_pipeline(target=GRID, auglist=list(AUGLIST_DCT_VITTI),
                                           num_ops=2, magnitude=3, k=K_TRAIN)
    for fmt in WIRE_FORMATS:  # every format at the ViT-Ti shapes, random rows
        flip, policy = vit_pipe.draw(gen, BATCH)
        err = held(f"{fmt} random rows ({BATCH}, {GRID}x{GRID})",
                   random_wire_rows(rng, BATCH, GRID, K_TRAIN, fmt), flip, policy, target=GRID,
                   k=K_TRAIN, fmt=fmt, ops_list=list(AUGLIST_DCT_VITTI), num_ops=2, magnitude=3)
        held(f"{fmt} random rows ({BATCH}, {GRID}x{GRID})",
             random_wire_rows(rng, BATCH, GRID, K_EVAL, fmt), target=GRID, k=K_EVAL, fmt=fmt)
        max_err = max(max_err, err)
        print(f"kernels: wire reader {fmt}, random rows at ({BATCH}, {GRID}x{GRID}): train "
              f"max abs err {err:.3e}, eval bit-exact", flush=True)

    shapes = {"vit_train": (BATCH, GRID, K_TRAIN, [AUGLIST_DCT, AUGLIST_DCT_VITTI]),
              "swin_train": (SWIN_TRAIN_BATCH, SWIN_GRID, K_TRAIN, [AUGLIST_DCT]),
              "vit_eval": (BATCH, GRID, K_EVAL, None),
              "swin_eval": (SWIN_EVAL_BATCH, SWIN_GRID, K_EVAL, None)}
    per_shape = {}
    for tag, (batch, grid, k, presets) in shapes.items():
        y, c = synthetic_planes(rng, batch, grid)
        rows = write_rows(y, c, (np.arange(batch) % 1000).astype(np.int32), k)
        packed = torch.from_numpy(rows).cuda()
        kw = dict(target=grid, k=k, fmt="mask16")
        if presets is None:
            held(f"{tag} ({batch}, {grid}x{grid}, K={k})", rows, **kw)
            fn = functools.partial(wire_to_range, packed, **kw)
            plain = functools.partial(wire_to_range_plain, packed, **kw)
            ops = 0
        else:
            for auglist in presets:  # the last is the path's own list
                kw.update(ops_list=list(auglist), num_ops=2, magnitude=3)
                pipe = make_cropped_train_pipeline(target=grid, auglist=list(auglist), num_ops=2,
                                                   magnitude=3, k=k)
                flip, policy = pipe.draw(gen, batch)
                max_err = max(max_err, held(f"{tag} ({batch}, {grid}x{grid}, K={k})", rows,
                                            flip, policy, **kw))
            flip, policy = flip.cuda(), tuple(p.cuda() for p in policy)
            fn = functools.partial(wire_flip_aug_range, packed, flip, policy, **kw)
            plain = functools.partial(wire_flip_aug_range_plain, packed, flip, policy, **kw)
            ops = 3 * kw["num_ops"]
        ms, dev_ms = time_ms(fn), device_ms(fn)
        plain_ms = time_ms(plain, reps=10, warmup=2)
        read, written = wire_read_bytes(rows, grid, k, "mask16"), sum(t.numel() * 4 for t in fn())
        t_bytes = (read + written) / PEAK_BYTES_PER_S
        # per coefficient: the decode (rank, test, scale), the entry clamp,
        # ToRange, and a multiply and a clamp per round
        t_ops = written / 4 * (8 + ops) / PEAK_F32_FLOP_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        per_shape[tag] = {"shape": [batch, grid, k], "ms": ms, "device_ms": dev_ms,
                          "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": "bytes" if t_bytes > t_ops else "operations",
                          "wire_bytes": read, "dense_bytes": written}
        print(f"kernels: {'wire_to_range' if presets is None else 'wire_flip_aug_range'} {tag} "
              f"({batch}, {grid}x{grid}, K={k}): {ms:.4f} ms (device {ms_text(dev_ms)}), plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({per_shape[tag]['bound_by']}: "
              f"{read / 1e6:.2f} MB of wire read, {written / 1e6:.2f} MB written; "
              f"{100 * bound / ms:.1f}% of it, "
              f"{'not measured' if dev_ms is None else f'{100 * bound / dev_ms:.1f}%'} of the "
              f"device time)", flush=True)
    main = per_shape["vit_train"]
    return {
        "name": "augpipe_wire", "route": "cuda", "source": "rgbnomore_tpu_torch/csrc/augpipe.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/augpipe.py:345",
        "entry": "the wire reader (augpipe_wire) of the same kernel: wire_flip_aug_range "
                 "(train) and wire_to_range (eval) read the mask16 rows themselves, with the "
                 "unpack of rgbnomore_tpu/augment/pipeline.py:89-136 in the same launch",
        "launches": None, "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "device_ms": main["device_ms"], "per_shape": per_shape,
    }


def window_cases(batch: int) -> list[tuple]:
    """(bw, h, n, d, P) of SwinV2-T's window attention at ``batch``: each
    stage unshifted (P = 1) and, where it shifts, shifted (P = nW)."""
    cases = []
    for wins, heads, shifted in SWIN_STAGES:
        cases.append((batch * wins, heads, WIN_N, WIN_D, 1))
        if shifted:
            cases.append((batch * wins, heads, WIN_N, WIN_D, shifted))
    return cases


def window_inputs(gen, case):
    """q (cosine-normalized, times SwinV2's initial logit scale 10), k
    (normalized), v, the output gradient and a bias with a shift-mask-like
    -100 on about a quarter of each pattern's entries."""
    import torch

    bw, h, n, d, p = case
    q, k, v, g = (torch.randn((bw, h, n, d), generator=gen, device="cuda") for _ in range(4))
    q = 10.0 * q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    bias = 16.0 * torch.rand((p, h, n, n), generator=gen, device="cuda")
    if p > 1:
        bias = bias - 100.0 * (torch.rand((p, 1, n, n), generator=gen, device="cuda") < 0.25)
    return q.contiguous(), k.contiguous(), v, g, bias.contiguous()


def window_bounds_ms(case) -> tuple[dict, dict]:
    """(forward, backward) bounds on the card (``product_bounds_ms``): q, k,
    v (and dO) read once, o (dq, dk, dv) written once, the bias read (and
    its gradient written) once, in float32; against 4 N^2 D (10 N^2 D) FLOP
    of products per (window, head)."""
    bw, h, n, d, p = case
    qkv = bw * h * n * d * 4
    bias = p * h * n * n * 4
    return (product_bounds_ms(4 * n * n * d * bw * h, 4 * qkv + bias),
            product_bounds_ms(10 * n * n * d * bw * h, 7 * qkv + 2 * bias))


def window_blocks(batch: int) -> list[tuple[tuple, int]]:
    """(case, blocks) of one SwinV2-T pass at ``batch``: each stage's even
    blocks unshifted, its odd ones shifted (stage 4, one window, never
    shifts)."""
    out = []
    for (wins, heads, shifted), n_blocks in zip(SWIN_STAGES, SWIN_BLOCKS_PER_STAGE):
        n_shift = n_blocks // 2 if shifted else 0
        out.append(((batch * wins, heads, WIN_N, WIN_D, 1), n_blocks - n_shift))
        if n_shift:
            out.append(((batch * wins, heads, WIN_N, WIN_D, shifted), n_shift))
    return out


def sdpa_mask(bias, bw: int):
    """The (P, H, N, N) bias as SDPA's (BW, H, N, N) ``attn_mask``, window w
    on pattern w % P: a broadcast view where P = 1, a copy otherwise."""
    p, h, n, _ = bias.shape
    if p == 1:
        return bias.expand(bw, h, n, n)
    return bias.expand(bw // p, p, h, n, n).reshape(bw, h, n, n)


def kernel_window_attention(gen) -> tuple[dict, dict]:
    """Kernels #3 and #4 against their plain versions at every SwinV2-T
    stage shape of the train batch (unshifted and shifted) and the JAX
    tests' shapes, with two backward runs bit-identical; then timed at each
    stage, unshifted and shifted, beside the plain versions, the bounds and
    SDPA (``attn_mask`` = the bias expanded to every window, ``scale=1``;
    its backward with the bias requiring grad), with the kernels' device
    time from ``torch.profiler``; the forward also at the eval batch.  The
    sums over one train step (12 forward, 12 backward calls) and one eval
    batch (12 forward calls) take each block's own case.  The report's
    numbers are stage 1, unshifted, the largest launch, with the sums and
    the main path's ``ptxas`` lines beside them."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_bwd,
        window_attention_bwd_plain,
        window_attention_plain,
    )

    fwd_err = bwd_err = 0.0
    for case in window_cases(SWIN_TRAIN_BATCH) + WIN_JAX_CASES:
        q, k, v, g, bias = window_inputs(gen, case)
        with torch.inference_mode():
            got = window_attention(q, k, v, bias)
            want = window_attention_plain(q, k, v, bias)
        grads = window_attention_bwd(q, k, v, bias, g)
        again = window_attention_bwd(q, k, v, bias, g)
        wgrads = window_attention_bwd_plain(q, k, v, bias, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        fwd_err = max(fwd_err, err)
        check(torch.allclose(got, want, **WIN_TOL),
              f"window_attention {case}: max abs err {err} beyond {WIN_TOL}")
        errs = []
        for tag, a, b, w in zip("qkvb", grads, again, wgrads):
            check(torch.equal(a, b), f"window_attention_bwd {case} d{tag} differs between runs")
            errs.append(float((a - w).abs().max()))
            check(torch.allclose(a, w, **GRAD_TOL),
                  f"window_attention_bwd {case} d{tag}: max abs err {errs[-1]} beyond {GRAD_TOL}")
        bwd_err = max(bwd_err, *errs)
        print(f"kernels: window_attention {case} fwd max abs err {err:.3e}, bwd dq/dk/dv/db "
              f"{'/'.join(f'{e:.1e}' for e in errs)}", flush=True)
        del q, k, v, g, bias, got, want, grads, again, wgrads

    def forward_times(case) -> dict:
        q, k, v, _, bias = window_inputs(gen, case)
        mask = sdpa_mask(bias, case[0])
        with torch.inference_mode():
            out = {"ms": time_ms(lambda: window_attention(q, k, v, bias)),
                   "device": device_ms(lambda: window_attention(q, k, v, bias)),
                   "plain": time_ms(lambda: window_attention_plain(q, k, v, bias),
                                    reps=10, warmup=2),
                   "sdpa": time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=1.0)),
                   "sdpa_device": device_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=1.0))}
        out["bound"] = window_bounds_ms(case)[0]
        return out

    def backward_times(case) -> dict:
        q, k, v, g, bias = window_inputs(gen, case)
        out = {"ms": time_ms(lambda: window_attention_bwd(q, k, v, bias, g)),
               "device": device_ms(lambda: window_attention_bwd(q, k, v, bias, g))}
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        res = window_attention_plain(*leaves)
        out["plain"] = time_ms(lambda: torch.autograd.grad(res, leaves, g, retain_graph=True),
                               reps=10, warmup=2)
        res = F.scaled_dot_product_attention(*leaves[:3], attn_mask=sdpa_mask(leaves[3], case[0]),
                                             scale=1.0)
        out["sdpa"] = time_ms(lambda: torch.autograd.grad(res, leaves, g, retain_graph=True))
        out["sdpa_device"] = device_ms(
            lambda: torch.autograd.grad(res, leaves, g, retain_graph=True))
        out["bound"] = window_bounds_ms(case)[1]
        return out

    def line(tag, case, r) -> str:
        (tc, tc_by), (f32, _) = r["bound"]["tc"], r["bound"]["f32"]
        return (f"kernels: {tag} {case}: {r['ms']:.4f} ms (device {ms_text(r['device'])}), plain "
                f"{r['plain']:.4f}, sdpa {r['sdpa']:.4f} (device {ms_text(r['sdpa_device'])}); "
                f"bound 3xTF32 {tc:.4f} ({tc_by}, {100 * tc / r['ms']:.1f}%), float32 "
                f"{f32:.4f} ({100 * f32 / r['ms']:.1f}%)")

    def sums(rows: dict, blocks) -> dict:
        """Sums over one pass's 12 calls, each block at its own case."""
        total = {}
        for key in ("ms", "device", "plain", "sdpa", "sdpa_device"):
            vals = [rows[case][key] for case, _ in blocks]
            total[key] = (None if any(x is None for x in vals)
                          else sum(nb * x for x, (_, nb) in zip(vals, blocks)))
        for key in ("tc", "f32"):
            total[key] = sum(nb * rows[case]["bound"][key][0] for case, nb in blocks)
        return total

    train, fwd_rows, bwd_rows = window_blocks(SWIN_TRAIN_BATCH), {}, {}
    for case, _ in train:
        fwd_rows[case] = forward_times(case)
        print(line("window_attention", case, fwd_rows[case]), flush=True)
        bwd_rows[case] = backward_times(case)
        print(line("window_attention_bwd", case, bwd_rows[case]), flush=True)
    evals, eval_rows = window_blocks(SWIN_EVAL_BATCH), {}
    for case, _ in evals:
        eval_rows[case] = forward_times(case)
        print(line("window_attention", case, eval_rows[case]), flush=True)
    step = {"fwd": sums(fwd_rows, train), "bwd": sums(bwd_rows, train),
            "eval": sums(eval_rows, evals)}
    for tag, what in (("fwd", f"per train step of {SWIN_TRAIN_BATCH}, forward"),
                      ("bwd", f"per train step of {SWIN_TRAIN_BATCH}, backward"),
                      ("eval", f"per eval batch of {SWIN_EVAL_BATCH}, forward")):
        t = step[tag]
        print(f"kernels: window_attention {what} (12 calls): {t['ms']:.4f} ms (device "
              f"{ms_text(t['device'])}), plain {t['plain']:.4f}, sdpa {t['sdpa']:.4f} (device "
              f"{ms_text(t['sdpa_device'])}); bound 3xTF32 {t['tc']:.4f}, float32 "
              f"{t['f32']:.4f}", flush=True)

    def entry(name, source, replaces, err, r, lib, kernel, per_pass):
        bounds = product_kernel_entry(r["ms"], r["bound"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain"],
                **bounds, "library_ms": r["sdpa"], "device_ms": r["device"],
                "library_device_ms": r["sdpa_device"],
                "ptxas": {k: v for k, v in PTXAS.get(lib, {}).items() if kernel in k},
                "per_pass": per_pass}

    main = train[0][0]  # stage 1, unshifted
    fwd = entry("window_attention", "rgbnomore_tpu_torch/csrc/window_attention_fwd.cu",
                "rgbnomore_tpu/ops/pallas/attention.py:156", fwd_err, fwd_rows[main],
                "window_attention_fwd", f"<{(WIN_D + 15) // 16},{(WIN_N + 15) // 16}>",
                {"train_step": step["fwd"], "eval_batch": step["eval"]})
    bwd = entry("window_attention_bwd", "rgbnomore_tpu_torch/csrc/window_attention_bwd.cu",
                "rgbnomore_tpu/ops/pallas/attention.py:170", bwd_err, bwd_rows[main],
                "window_attention_bwd", f"<{(WIN_D + 15) // 16},{(WIN_N + 15) // 16}>",
                {"train_step": step["bwd"]})
    return fwd, bwd


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {"fused_attention": kernel_attention_fwd(gen)}
    report["fused_attention_bwd"] = kernel_attention_bwd(gen)
    report["fused_flip_aug_range"] = kernel_augpipe()
    report["augpipe_wire"] = kernel_augpipe_wire()
    report["window_attention"], report["window_attention_bwd"] = kernel_window_attention(gen)
    return report


def augpipe_wrappers() -> dict:
    """The input stage's wrappers: the kernel's dense entry and its wire
    reader's train and eval entries."""
    from rgbnomore_tpu_torch.ops.augpipe import (
        fused_flip_aug_range,
        wire_flip_aug_range,
        wire_to_range,
    )

    return {"fused_flip_aug_range": fused_flip_aug_range,
            "wire_flip_aug_range": wire_flip_aug_range, "wire_to_range": wire_to_range}


@contextlib.contextmanager
def plain_unpacks():
    """Counts the calls of the plain mask16 unpack (``augment.pipeline.
    unpack_coefficients_mask``) made while the block runs: a path that the
    wire reader carries makes none."""
    from rgbnomore_tpu_torch.augment import pipeline

    unpack, calls = pipeline.unpack_coefficients_mask, []

    def counted(*args, **kw):
        calls.append(1)
        return unpack(*args, **kw)

    pipeline.unpack_coefficients_mask = counted
    try:
        yield calls
    finally:
        pipeline.unpack_coefficients_mask = unpack


def check_input_stage(report: dict, path: str, launches: dict, unpacks: int, *,
                      eval_batches: int = 0, train_steps: int = 0) -> None:
    """One wire launch per eval batch and per train step, no launch of the
    dense entry and no plain unpack on ``path``; the #5 entries' launches
    are kept per path, and their ``launches`` is the sum over the paths."""
    want = {"fused_flip_aug_range": 0, "wire_flip_aug_range": train_steps,
            "wire_to_range": eval_batches}
    got = {name: launches[name] for name in want}
    check(got == want and unpacks == 0,
          f"{path}: input stage launches {got} and {unpacks} plain unpacks; want {want} and none")
    for name, wrappers in (("fused_flip_aug_range", ("fused_flip_aug_range",)),
                           ("augpipe_wire", ("wire_flip_aug_range", "wire_to_range"))):
        by_path = report[name].setdefault("launches_by_path", {})
        by_path[path] = sum(got[w] for w in wrappers)
        report[name]["launches"] = sum(by_path.values())


def phase_slice(report: dict):
    import copy

    import torch

    from rgbnomore_tpu_torch.ops.attention import attention_plain, fused_attention
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED)
    trainer = Trainer(cfg, device="cuda")  # full-width ViT-Ti, seeded init
    check(trainer.packed_k_eval == K_EVAL and trainer.eval_fmt == "mask16",
          f"eval wire is K={trainer.packed_k_eval} {trainer.eval_fmt}")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    y, c = synthetic_planes(rng, N_IMAGES, GRID)
    labels = (np.arange(N_IMAGES) % cfg.model.classes).astype(np.int32)
    rows = write_rows(y, c, labels, K_EVAL)
    batches = [{"packed": rows[i:i + BATCH]} for i in range(0, N_IMAGES, BATCH)]
    print(f"slice: wrote {N_IMAGES} rows of {rows.shape[1]} B in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    trainer.evaluate(batches)  # warm-up: cuBLAS handles, allocator, pinned buffers
    wrappers = {"fused_attention": fused_attention, **augpipe_wrappers()}
    for w in wrappers.values():
        w.launches = 0
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        res = trainer.evaluate(batches)  # ends in a host read of every sum
        eval_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    report["fused_attention"]["launches"] = launches["fused_attention"]
    check_input_stage(report, "vit_eval", launches, len(unpacks), eval_batches=len(batches))
    per_batch = cfg.model.depth  # one attention launch per encoder block
    check(res["count"] == N_IMAGES, f"eval counted {res['count']} images, want {N_IMAGES}")
    check(math.isfinite(res["loss"]) and math.isfinite(res["accuracy"]),
          f"eval sums not finite: {res}")
    check(launches["fused_attention"] == per_batch * len(batches),
          f"fused_attention launched {launches['fused_attention']} times, want "
          f"{per_batch * len(batches)}")
    print(f"slice: eval {res} | {N_IMAGES / eval_s:.1f} img/s (upload + pipeline + "
          f"forward, rows premade) | launches {launches}", flush=True)

    model = trainer.model
    cpu_model = copy.deepcopy(model).cpu()
    packed = trainer.put_batch(batches[0])["packed"]
    with torch.inference_mode():
        yd, cd, _, _ = trainer.eval_pipe(packed)
        # the pipeline on the card is bit-exact against the CPU
        yc, cc, _, _ = trainer.eval_pipe(torch.from_numpy(batches[0]["packed"]))
        check(torch.equal(yd.cpu(), yc) and torch.equal(cd.cpu(), cc),
              "pipeline on the card differs from the CPU")
        got = model(yd, cd)
        mhas = [getattr(model, f"encoder_{i}").mha for i in range(model.depth)]
        for m in mhas:
            m.attention = attention_plain
        want = model(yd, cd)
        for m in mhas:
            m.attention = fused_attention
        cpu_logits = cpu_model(yc[:8], cc[:8])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"kernel-path logits vs plain path: max abs err {err} beyond {LOGIT_TOL}")
    # argmax agrees except where the plain path's top two are within tolerance
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    rows_off = (a_got != a_want).nonzero().flatten()
    gaps = (want[rows_off, a_want[rows_off]] - want[rows_off, a_got[rows_off]]).abs()
    check(bool((gaps <= LOGIT_TOL["atol"]).all()),
          f"argmax differs on {rows_off.tolist()} with logit gaps {gaps.tolist()}")
    cpu_err = float((got[:8].cpu() - cpu_logits).abs().max())
    check(torch.allclose(got[:8].cpu(), cpu_logits, **LOGIT_TOL),
          f"card logits vs CPU: max abs err {cpu_err} beyond {LOGIT_TOL}")
    check(bool(torch.isfinite(got).all()) and got.shape == (BATCH, cfg.model.classes),
          f"logits {tuple(got.shape)} not finite or not (batch, classes)")
    print(f"slice: logits kernel vs plain max abs err {err:.3e} "
          f"({len(rows_off)} argmax ties), card vs CPU {cpu_err:.3e}", flush=True)
    return trainer, batches[0]


def phase_breakdown(trainer, batch: dict, tag: str = "breakdown") -> None:
    """Where one eval step's time goes on the card: CUDA-event medians of
    each stage, and the device time of one forward by kernel, from
    ``torch.profiler`` (reported as not measured where it sees none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.train.steps import eval_sums

    model = trainer.model.eval()
    n = batch["packed"].shape[0]
    with torch.inference_mode():
        upload_ms = time_ms(lambda: trainer.put_batch(batch), reps=10, warmup=2)
        # the upload before the reused pinned ring, on the same batch
        pin_ms = time_ms(lambda: torch.from_numpy(batch["packed"]).pin_memory().to(
            trainer.device, non_blocking=True), reps=10, warmup=2)
        packed = trainer.put_batch(batch)["packed"]
        pipe_ms = time_ms(lambda: trainer.eval_pipe(packed), reps=10, warmup=2)
        y, c, labels, weights = trainer.eval_pipe(packed)
        fwd_ms = time_ms(lambda: model(y, c), reps=20, warmup=3)
        logits = model(y, c)
        sums_ms = time_ms(lambda: eval_sums(logits, labels, weights), reps=10, warmup=2)
        print(f"{tag}: per batch of {n}: upload {upload_ms:.3f} ms (pin_memory() + copy "
              f"{pin_ms:.3f} ms), pipeline {pipe_ms:.3f} ms, forward {fwd_ms:.3f} ms "
              f"({n / fwd_ms * 1e3:.1f} img/s), sums {sums_ms:.3f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(y, c)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print(f"{tag}: torch.profiler saw no device time, kernels not measured")
        return
    print(f"{tag}: forward device time {total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"{tag}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def phase_train(report: dict):
    """The train step at full width: launch counts, finite losses and the
    loss falling over 20 steps on one repeated batch (warmup 1, lr 3e-3).
    256 images with labels ``arange % 1000`` leave 744 classes unused, whose
    logits alone make the loss fall from ln 1000."""
    import torch

    from rgbnomore_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED, epochs=1,
                          warmup_steps=1, lr=3e-3)
    trainer = Trainer(cfg, device="cuda")
    pipe = trainer.train_pipe
    check(pipe.k == K_TRAIN and pipe.fmt == "mask16" and pipe.num_ops == 2
          and pipe.magnitude == 3 and pipe.ops_list == list(cfg.train.auglist),
          f"train wire K={pipe.k} {pipe.fmt}, {pipe.num_ops} ops at {pipe.magnitude}")
    trainer.create_state(steps_per_epoch=TRAIN_STEPS + 1)
    rng = np.random.default_rng(SEED + 1)
    y, c = synthetic_planes(rng, BATCH, GRID)
    labels = (np.arange(BATCH) % cfg.model.classes).astype(np.int32)
    rows = write_rows(y, c, labels, K_TRAIN)
    packed = trainer.put_batch({"packed": rows})["packed"]

    losses = [trainer.train_step(packed)]  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    wrappers = {"fused_attention": fused_attention, "fused_attention_bwd": fused_attention_bwd,
                **augpipe_wrappers()}
    for w in wrappers.values():
        w.launches = 0
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(trainer.train_step(packed))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    check_input_stage(report, "vit_train", launches, len(unpacks), train_steps=TRAIN_STEPS)
    want = {"fused_attention": 12 * TRAIN_STEPS, "fused_attention_bwd": 12 * TRAIN_STEPS}
    for name in want:
        report[name]["launches"] = launches[name]
    check(all(launches[n] == want[n] for n in want), f"train launches {launches}, want {want}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    print(f"train: {TRAIN_STEPS} steps of {BATCH} in {train_s:.3f} s, "
          f"{TRAIN_STEPS * BATCH / train_s:.1f} img/s (pipeline + step, one resident batch) | "
          f"launches {launches} | loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    print(f"train: losses {[round(v, 4) for v in losses]}", flush=True)
    return trainer, packed, rows


def phase_train_vs_cpu(rows: np.ndarray) -> None:
    """One ViT-Ti step's loss and gradients on the card (kernels) against
    the CPU (plain versions), from the same seeded parameters, rows and
    draws, at full width on 8 images."""
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=CPU_GRAD_BATCH, seed=SEED)
    step_card_vs_cpu("train", cfg, rows[:CPU_GRAD_BATCH])


def step_card_vs_cpu(tag: str, cfg, rows: np.ndarray, prepare=None) -> None:
    """One train step's loss and gradients on the card (kernels) against the
    CPU (plain versions), from the same seeded parameters (then ``prepare``
    on each model), rows and draws.  Tolerance: float32 sums in other orders
    (cuBLAS against the CPU's GEMMs, the kernels' tiles against einsum)
    through every block and back; a parameter is held to GRAD_RTOL of the
    largest gradient entry in the model, so an entry whose gradient is zero
    in exact arithmetic and rounding noise here (the key third of each ViT
    qkv bias) is held to that noise's scale."""
    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    n = rows.shape[0]
    card, cpu = Trainer(cfg, device="cuda"), Trainer(cfg, device="cpu")
    if prepare is not None:
        prepare(card.model)
        prepare(cpu.model)
    draws = cpu.draw(n)
    loss_card = float(card.compute_grads(card.put_batch({"packed": rows})["packed"], draws))
    loss_cpu = float(cpu.compute_grads(torch.from_numpy(rows), draws))
    grads_card = {k: p.grad.cpu() for k, p in card.model.named_parameters()}
    grads_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
    norm_card = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_card.values()])))
    norm_cpu = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_cpu.values()])))
    gmax = max(float(g.abs().max()) for g in grads_cpu.values())
    worst = max(((float((grads_card[k] - g).abs().max()) / gmax, k)
                 for k, g in grads_cpu.items()))
    rel = {k: float((grads_card[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for k, g in grads_cpu.items()}
    worst_own = max((v, k) for k, v in rel.items() if not k.endswith("qkv.bias"))
    print(f"{tag}: card vs CPU at {n} images: loss {loss_card:.7f} vs "
          f"{loss_cpu:.7f}, grad norm {norm_card:.7f} vs {norm_cpu:.7f}, worst gradient "
          f"err {worst[0]:.3e} of the largest entry ({worst[1]}), worst relative to its own "
          f"largest entry {worst_own[0]:.3e} ({worst_own[1]})", flush=True)
    check(abs(loss_card - loss_cpu) <= LOSS_RTOL * abs(loss_cpu),
          f"{tag}: loss card {loss_card} vs CPU {loss_cpu} beyond rtol {LOSS_RTOL}")
    check(abs(norm_card - norm_cpu) <= GRAD_RTOL * norm_cpu,
          f"{tag}: grad norm card {norm_card} vs CPU {norm_cpu} beyond rtol {GRAD_RTOL}")
    check(worst[0] <= GRAD_RTOL,
          f"{tag}: gradient of {worst[1]}: err {worst[0]} of the largest entry, beyond "
          f"{GRAD_RTOL}")


def phase_train_breakdown(trainer, packed, tag: str = "breakdown") -> None:
    """Where one train step's time goes on the card: CUDA-event medians of
    its stages (as ``Trainer.train_step`` runs them), and the device time of
    one step by kernel from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.train.steps import mixup_batch, softmax_cross_entropy

    stages = ("pipeline", "forward", "backward", "optimizer")
    times = {s: [] for s in stages}
    classes = trainer.cfg.model.classes
    batch = packed.shape[0]
    trainer.model.train()
    for _ in range(10):
        draws = trainer.draw(batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        y, c, labels, _ = trainer.train_pipe(packed, draws.flip, draws.policy)
        extra = {} if draws.drop_keep is None else {"drop_keep": draws.drop_keep.cuda()}
        ev[1].record()
        (y, c), targets = mixup_batch((y, c), labels, classes, draws.lam)
        loss = softmax_cross_entropy(trainer.model(y, c, **extra), targets)
        ev[2].record()
        trainer.model.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        trainer.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        for i, s in enumerate(stages):
            times[s].append(ev[i].elapsed_time(ev[i + 1]))
    med = {s: statistics.median(v) for s, v in times.items()}
    total = sum(med.values())
    print(f"{tag}: train step of {batch}: " + ", ".join(
        f"{s} {med[s]:.3f} ms" for s in stages) + f"; sum {total:.3f} ms "
        f"({batch / total * 1e3:.1f} img/s)", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(packed)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_total = sum(e.self_device_time_total for e in events)
    if not dev_total:
        print(f"{tag}: torch.profiler saw no device time, kernels not measured")
        return
    print(f"{tag}: train step device time {dev_total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"{tag}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / dev_total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def swin_config(batch: int, **kw):
    """SwinV2-T as the repo presets it (``generate_config("swinv2", "dct")``:
    embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 8, drop path
    0.2, 32x32 blocks, 1000 classes), in float32: the preset's AMP is the
    port's next slice."""
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config("swinv2", "dct", batchsize=batch, seed=SEED, **kw)
    cfg.train.amp = False
    return cfg


def perturb_norms(model, seed: int = SEED) -> None:
    """Set the scales of every SwinV2 block's norm1 and norm2 to U(0.5, 1.5)
    and their biases to N(0, 0.1^2), from a seeded generator: at their init
    of 0 every block is the identity and no attention reaches the logits."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith((".norm1", ".norm2")):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)


def phase_swin_eval(report: dict):
    """512 images of 32x32 blocks on the K=48 wire through the SwinV2-T
    ``Trainer.evaluate`` (norms perturbed), 12 window-attention launches per
    batch; logits of the kernel path against the plain path, and the card
    against the CPU at 4 images."""
    import copy

    import torch

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_plain,
    )
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = swin_config(SWIN_EVAL_BATCH)
    trainer = Trainer(cfg, device="cuda")
    perturb_norms(trainer.model)
    check(trainer.packed_k_eval == K_EVAL and trainer.eval_fmt == "mask16",
          f"swin eval wire is K={trainer.packed_k_eval} {trainer.eval_fmt}")
    rng = np.random.default_rng(SEED + 2)
    y, c = synthetic_planes(rng, N_IMAGES, SWIN_GRID)
    labels = (np.arange(N_IMAGES) % cfg.model.classes).astype(np.int32)
    rows = write_rows(y, c, labels, K_EVAL)
    batches = [{"packed": rows[i:i + SWIN_EVAL_BATCH]}
               for i in range(0, N_IMAGES, SWIN_EVAL_BATCH)]

    trainer.evaluate(batches)  # warm-up
    wrappers = {"window_attention": window_attention, **augpipe_wrappers()}
    for w in wrappers.values():
        w.launches = 0
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        res = trainer.evaluate(batches)
        eval_s = time.perf_counter() - t0
    check_input_stage(report, "swin_eval", {n: w.launches for n, w in wrappers.items()},
                      len(unpacks), eval_batches=len(batches))
    launches = window_attention.launches
    report["window_attention"]["launches"] = launches
    check(res["count"] == N_IMAGES, f"swin eval counted {res['count']} images")
    check(math.isfinite(res["loss"]) and math.isfinite(res["accuracy"]),
          f"swin eval sums not finite: {res}")
    check(launches == 12 * len(batches),
          f"window_attention launched {launches} times, want {12 * len(batches)}")
    print(f"swin eval: {res} | {N_IMAGES / eval_s:.1f} img/s (upload + pipeline + forward, "
          f"rows premade) | window_attention launches {launches}", flush=True)

    model = trainer.model
    cpu_model = copy.deepcopy(model).cpu()
    attns = [b.attn for b in model.blocks()]
    with torch.inference_mode():
        yd, cd, _, _ = trainer.eval_pipe(trainer.put_batch(batches[0])["packed"])
        got = model(yd, cd)
        for a in attns:
            a.attention = window_attention_plain
        want = model(yd, cd)
        for a in attns:
            a.attention = window_attention
        cpu_logits = cpu_model(yd[:SWIN_CPU_BATCH].cpu(), cd[:SWIN_CPU_BATCH].cpu())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"swin logits kernel vs plain: max abs err {err} beyond {LOGIT_TOL}")
    cpu_err = float((got[:SWIN_CPU_BATCH].cpu() - cpu_logits).abs().max())
    check(torch.allclose(got[:SWIN_CPU_BATCH].cpu(), cpu_logits, **LOGIT_TOL),
          f"swin logits card vs CPU: max abs err {cpu_err} beyond {LOGIT_TOL}")
    check(bool(torch.isfinite(got).all()) and got.shape == (SWIN_EVAL_BATCH, cfg.model.classes),
          f"swin logits {tuple(got.shape)} not finite or not (batch, classes)")
    print(f"swin eval: logits kernel vs plain max abs err {err:.3e} (logits up to "
          f"{float(want.abs().max()):.3f}), card vs CPU {cpu_err:.3e}", flush=True)
    return trainer, batches[0]


def cell_image(rng: np.random.Generator, size: int = 256):
    """RGB uint8 (3, size, size) of constant 16x16 cells, and each cell's
    colour (size/16, size/16, 3): every 8x8 luma block and, after 4:2:0
    subsampling, every chroma block is constant, so a JPEG of it at quality
    100 has no AC terms and DCs of 8 * (level - 128)."""
    cells = rng.integers(0, 256, (size // 16, size // 16, 3)).astype(np.uint8)
    img = np.repeat(np.repeat(cells, 16, axis=0), 16, axis=1)
    return np.ascontiguousarray(img.transpose(2, 0, 1)), cells.astype(np.float64)


def phase_codec(trainer) -> None:
    """JPEG files through the host codec: 256 files written by the port's
    codec (16 of constant colour cells at quality 100, 240 photo-like ones
    of 500x375 or 375x500 at quality 90), read by ``DctCroppedLoader``
    (the SwinV2 eval: whole-image resize to 32x32 blocks, K=48) at 1, 2, 4
    and 8 decode threads.  The cell images' DC planes are held to JFIF's
    colour conversion within one level and their AC masks to empty; one
    batch then runs through the SwinV2 eval."""
    from rgbnomore_tpu_torch import codec
    from rgbnomore_tpu_torch.data.index import load_index
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader, row_views
    from rgbnomore_tpu_torch.ops.cuda_build import BUILD_DIR

    rng = np.random.default_rng(SEED + 3)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lines, cells = ["Filepath,Label"], []
        t0 = time.perf_counter()
        for i in range(N_CODEC):
            path = f"{tmp}/img{i:03d}.jpg"
            if i < N_CELL_IMAGES:
                img, colours = cell_image(rng)
                cells.append(colours)
                codec.write_tensor(path, img, quality=100)
            else:
                h, w = (375, 500) if i % 2 else (500, 375)
                ys, xs = np.mgrid[0:h, 0:w]
                f = 0.01 + 0.05 * rng.random(3)
                img = np.stack([(128 + 90 * np.sin(ys * f[ch] + ch) * np.cos(xs * f[2 - ch])
                                 + 12 * rng.standard_normal((h, w))).clip(0, 255)
                                for ch in range(3)]).astype(np.uint8)
                codec.write_tensor(path, img, quality=90)
            lines.append(f"{path},{i % 1000}")
        with open(f"{tmp}/index.csv", "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"codec: wrote {N_CODEC} JPEGs in {time.perf_counter() - t0:.1f} s", flush=True)
        ds = load_index(f"{tmp}/index.csv")
        rates = {}
        for threads in (1, 2, 4, 8):
            ldr = DctCroppedLoader(ds, SWIN_EVAL_BATCH, target=SWIN_GRID, k=K_EVAL,
                                   mode="full", num_threads=threads)
            t0 = time.perf_counter()
            batches = list(ldr)
            rates[threads] = N_CODEC / (time.perf_counter() - t0)
        print("codec: host decode + full resize + pack to 32x32 blocks, K=48: " + ", ".join(
            f"{t} threads {r:.1f} img/s" for t, r in rates.items()), flush=True)
    check(len(batches) == 1 and batches[0]["weights"].sum() == N_CODEC,
          f"loader gave {len(batches)} batches")
    rows = batches[0]["packed"]
    worst = 0.0
    for i, colours in enumerate(cells):
        v = row_views(rows[i], ldr.layout)
        r, g, b = colours[..., 0], colours[..., 1], colours[..., 2]
        luma = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        want_y = np.repeat(np.repeat(luma, 2, axis=0), 2, axis=1)  # 2x2 blocks per cell
        got = [v["dy"][0], v["dc"][0], v["dc"][1]]
        for plane, want in zip(got, (want_y, cb, cr)):
            err = float(np.abs(plane / 8.0 + 128.0 - want).max())
            worst = max(worst, err)
            check(err <= 1.0, f"codec: image {i} DC off by {err} levels from the closed form")
        check(not v["iy"].any() and not v["ic"].any(),
              f"codec: image {i} of constant blocks kept AC terms")
    print(f"codec: {len(cells)} cell images: DCs within {worst:.3f} levels of the closed "
          f"form, no AC terms", flush=True)
    res = trainer.evaluate(batches)
    check(res["count"] == N_CODEC and math.isfinite(res["loss"]),
          f"codec: swin eval of the decoded batch gave {res}")
    print(f"codec: one batch of {N_CODEC} decoded JPEGs through the SwinV2-T eval: {res}",
          flush=True)


def phase_swin_train(report: dict):
    """The SwinV2-T train step at batch 128 with drop path 0.2: launch counts
    (1 augmentation, 12 window forward, 24 window backward: 12 per-chunk
    passes and 12 reductions), finite losses falling over 1 + 10 steps on one
    repeated batch (warmup 1, lr 3e-3), and the peak device memory."""
    import torch

    from rgbnomore_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = swin_config(SWIN_TRAIN_BATCH, epochs=1, warmup_steps=1, lr=3e-3)
    trainer = Trainer(cfg, device="cuda")
    pipe = trainer.train_pipe
    check(pipe.k == K_TRAIN and pipe.fmt == "mask16" and pipe.num_ops == 2
          and pipe.magnitude == 3 and pipe.ops_list == list(AUGLIST_DCT)
          and pipe.target == SWIN_GRID,
          f"swin train wire K={pipe.k} {pipe.fmt}, {pipe.num_ops} ops at {pipe.magnitude}")
    check(abs(trainer.model.drop_path_rates[-1] - 0.2) < 1e-9, "swin drop path is not 0.2")
    trainer.create_state(steps_per_epoch=SWIN_TRAIN_STEPS + 1)
    rng = np.random.default_rng(SEED + 4)
    y, c = synthetic_planes(rng, SWIN_TRAIN_BATCH, SWIN_GRID)
    labels = (np.arange(SWIN_TRAIN_BATCH) % cfg.model.classes).astype(np.int32)
    rows = write_rows(y, c, labels, K_TRAIN)
    packed = trainer.put_batch({"packed": rows})["packed"]

    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(packed)]  # warm-up
    torch.cuda.synchronize()
    wrappers = {"window_attention": window_attention, "window_attention_bwd": window_attention_bwd,
                **augpipe_wrappers()}
    for w in wrappers.values():
        w.launches = 0
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        for _ in range(SWIN_TRAIN_STEPS):
            losses.append(trainer.train_step(packed))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: w.launches for name, w in wrappers.items()}
    check_input_stage(report, "swin_train", launches, len(unpacks), train_steps=SWIN_TRAIN_STEPS)
    want = {"window_attention": 12 * SWIN_TRAIN_STEPS, "window_attention_bwd": 24 * SWIN_TRAIN_STEPS}
    for name in want:
        report[name]["launches"] = launches[name]
    check(all(launches[n] == want[n] for n in want), f"swin train launches {launches}, want {want}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"swin train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"swin loss did not fall over {SWIN_TRAIN_STEPS} steps: {losses}")
    print(f"swin train: {SWIN_TRAIN_STEPS} steps of {SWIN_TRAIN_BATCH} in {train_s:.3f} s, "
          f"{SWIN_TRAIN_STEPS * SWIN_TRAIN_BATCH / train_s:.1f} img/s (pipeline + step, one "
          f"resident batch) | launches {launches} | loss {losses[0]:.4f} -> {losses[-1]:.4f} | "
          f"peak memory {peak_gib:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    print(f"swin train: losses {[round(v, 4) for v in losses]}", flush=True)
    return trainer, packed, rows


def swin_steps_from_one_state(cfg) -> tuple[list[float], bool]:
    """Two SwinV2-T train steps of ``cfg`` at batch 128, each from the same
    seeded state, rows and draws (two Trainers): their losses, and whether
    every parameter after them is bit-identical."""
    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 4)
    y, c = synthetic_planes(rng, SWIN_TRAIN_BATCH, SWIN_GRID)
    rows = write_rows(y, c, (np.arange(SWIN_TRAIN_BATCH) % 1000).astype(np.int32), K_TRAIN)
    losses, params, draws = [], [], None
    for _ in range(2):
        trainer = Trainer(cfg, device="cuda")
        trainer.create_state(steps_per_epoch=2)
        if draws is None:
            draws = trainer.draw(SWIN_TRAIN_BATCH)
        losses.append(float(trainer.train_step(trainer.put_batch({"packed": rows})["packed"],
                                               draws)))
        params.append({k: p.detach().clone() for k, p in trainer.model.named_parameters()})
        del trainer
    same = losses[0] == losses[1] and all(torch.equal(params[0][k], params[1][k])
                                          for k in params[0])
    return losses, same


def determinism_child() -> int:
    """The child of ``phase_determinism``: ``swin_steps_from_one_state`` with
    ``cfg.train.deterministic`` set, in a process whose first cuBLAS handle
    is made after ``configure_determinism``; prints one JSON line."""
    import os

    import torch

    losses, same = swin_steps_from_one_state(swin_config(SWIN_TRAIN_BATCH, epochs=1,
                                                         warmup_steps=1, lr=3e-3,
                                                         deterministic=True))
    print(json.dumps({"determinism": {
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "losses": losses, "bit_identical": same}}))
    return 0


def phase_determinism() -> None:
    """Is SwinV2-T's train step bit-reproducible on the card?  With
    ``cfg.train.deterministic`` (``configure_determinism``), in a child
    process: this one made its cuBLAS handles long ago.  Two steps from one
    state must give bit-identical parameters, or the phase fails.  The same
    two steps without the flag, in this process, are reported beside it."""
    res = subprocess.run([sys.executable, __file__, "--determinism"], capture_output=True,
                         text=True, timeout=600)
    check(res.returncode == 0,
          f"determinism child exit {res.returncode}: {res.stderr[-4000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])["determinism"]
    off_losses, off_same = swin_steps_from_one_state(swin_config(
        SWIN_TRAIN_BATCH, epochs=1, warmup_steps=1, lr=3e-3))
    print(f"determinism: SwinV2-T train step at batch {SWIN_TRAIN_BATCH}, twice from one "
          f"state: with cfg.train.deterministic (deterministic algorithms "
          f"{got['deterministic_algorithms']}, CUBLAS_WORKSPACE_CONFIG "
          f"{got['cublas_workspace_config']}) bit-identical: {got['bit_identical']} (losses "
          f"{got['losses']}); without it: {off_same} (losses {off_losses})", flush=True)
    check(got["deterministic_algorithms"] and got["bit_identical"],
          f"SwinV2-T's deterministic train step is not bit-reproducible: {got}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import rgbnomore_tpu_torch  # noqa: F401  (fails here when run outside a checkout)

    # a float32 reference compares in float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--determinism"]:
        return determinism_child()
    print(phase_card(), flush=True)
    phase_build()
    report = phase_kernels()
    trainer, batch = phase_slice(report)
    phase_breakdown(trainer, batch)
    del trainer
    trainer, packed, rows = phase_train(report)
    phase_train_vs_cpu(rows)
    phase_train_breakdown(trainer, packed)
    del trainer, packed
    trainer, batch = phase_swin_eval(report)
    phase_breakdown(trainer, batch, "swin breakdown")
    phase_codec(trainer)
    del trainer, batch
    trainer, packed, rows = phase_swin_train(report)
    step_card_vs_cpu("swin train", swin_config(SWIN_CPU_BATCH), rows[:SWIN_CPU_BATCH],
                     perturb_norms)
    phase_train_breakdown(trainer, packed, "swin breakdown")
    del trainer, packed
    phase_determinism()
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
