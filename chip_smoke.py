#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``rgbnomore_tpu_torch/csrc/``
with ``nvcc`` for ``sm_90a``, holds each kernel against its plain PyTorch
version on the card, then drives the port's two paths at full ViT-Ti width:
evaluation over the cropped DCT wire (K=48 ``mask16`` rows, batch 256)
through ``Trainer.evaluate``, and the train step over the K=16 train wire
(batch 256) through ``Trainer.train_step``; it checks that every kernel of
each path was launched and that what comes out is right.

Phases, each raising on failure (the script then exits non-zero):
  1. card: print ``nvidia-smi --query-gpu=name,power.limit`` for the card;
  2. build: compile the kernels, one ``nvcc`` per source, started together;
  3. kernels: each kernel (attention forward, attention backward, the fused
     flip + RandAugment + ToRange stage) against its plain version at the
     main path's shapes and the JAX package's test shapes, then timed with
     CUDA events beside its plain version, its bound and, where one exists,
     a PyTorch library call;
  4. slice: 512 images through ``Trainer.evaluate`` with launch counts; the
     pipeline on the card against the CPU, logits of the kernel path against
     the plain path and against the CPU;
  5. breakdown: the time of each stage of one eval step, and of each kernel
     of one forward (``torch.profiler``);
  6. train: 1 + 20 steps of ``Trainer.train_step`` on one repeated batch of
     256 images (warmup 1, lr 3e-3) with launch counts (1 augmentation, 12
     attention forward and 12 attention backward launches per step), finite
     losses and a last loss below the first; one step's loss and gradients
     on the card against the CPU at 8 images; the time of each stage of a
     step and of each kernel of one step.

The host JPEG codec needs libjpeg's headers, which the card machine does not
have, so both paths are fed rows that this script writes itself in the
``mask16`` layout of ``DctCroppedLoader`` from seeded synthetic coefficient
planes (``write_rows``; ``tests/test_torch_port_eval.py`` holds it against
the port's pipeline).  The last two lines of standard output are the kernel
report and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
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
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


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


def write_rows(y: np.ndarray, c: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Consolidated (n, row) uint8 rows in ``packed_layout(grid, k,
    "mask16")``, as ``DctCroppedLoader`` writes them, for planes y, c."""
    from rgbnomore_tpu_torch.data.loader import packed_layout, row_views

    n, grid = y.shape[0], y.shape[2]
    layout = packed_layout(grid, k, "mask16")
    packed = {}
    for tag, planes in (("y", y), ("c", c)):
        vals, mask, scale, dc = pack_mask16(planes.reshape(-1, 64), k)
        lead = planes.shape[:4]
        packed[tag] = (vals.reshape(lead + (k,)), mask.reshape(lead + (8,)),
                       scale.reshape(lead), dc.reshape(lead))
    rows = np.zeros((n, layout["row"]), np.uint8)
    for i in range(n):
        v = row_views(rows[i], layout)
        for tag in ("y", "c"):
            vals, mask, scale, dc = packed[tag]
            v[f"v{tag}"][...] = vals[i]
            v[f"i{tag}"][...] = mask[i]
            v[f"s{tag}"][...] = scale[i]
            v[f"d{tag}"][...] = dc[i]
        v["quant"][...] = 1
        v["labels"][...] = labels[i]
        v["weights"][...] = 1.0
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


def attention_bound_ms(b: int, h: int, n: int, d: int) -> tuple[float, str]:
    """Least time for softmax(QKᵀ)V on the card: q, k, v read and o written
    once in float32, against 4*N^2*D*B*H float32 FLOP (QKᵀ and PV)."""
    t_bytes = 4 * b * h * n * d * 4 / PEAK_BYTES_PER_S
    t_ops = 4 * n * n * d * b * h / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


# ---------------------------------------------------------------- phases
def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi listed no card")
    return out[0]


def phase_build() -> None:
    from rgbnomore_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    print(f"build: {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"(host codec not built: it needs libjpeg headers)", flush=True)
    for name, path in paths.items():
        # one "template args: registers, spill bytes" entry per compiled kernel
        entries, args = [], "?"
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "Compiling entry function" in line:
                args = ",".join(re.findall(r"Li(\d+)E", line)) or "-"
            elif "spill stores" in line:
                spills = re.findall(r"(\d+) bytes spill", line)
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                entries.append(f"<{args}> {regs} regs, spills {'/'.join(spills)} B")
        print(f"build: {name}: " + "; ".join(entries), flush=True)


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
    bound_ms, bound_by = attention_bound_ms(b, h, n, d)
    print(f"kernels: fused_attention {ATTN_SHAPES[0]} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {
        "name": "fused_attention", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:39",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
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
    ms = time_ms(lambda: fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = attention_plain(*leaves, ATTN_SCALE)
    plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True),
                       reps=10, warmup=2)
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=ATTN_SCALE)
    library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    # the five products of the VJP in float32; q, k, v, out, dout and lse
    # read once, dq, dk, dv written once
    t_ops = 10 * n * n * d * b * h / PEAK_F32_FLOP_PER_S
    t_bytes = (8 * q.numel() + lse.numel()) * 4 / PEAK_BYTES_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    print(f"kernels: fused_attention_bwd {(b, h, n, d)} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {
        "name": "fused_attention_bwd", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:51",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def kernel_augpipe() -> dict:
    """The fused flip + RandAugment + ToRange kernel against its plain
    version: each of the 16 ops forced with the explicit policy and flip of
    ``tests/test_pallas_augpipe.py:56-76`` at its shape, and policies drawn
    from both presets at the main path's (256, 28x28); then timed there."""
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
    for tag, auglist in (("AUGLIST_DCT", AUGLIST_DCT), ("AUGLIST_DCT_VITTI", AUGLIST_DCT_VITTI)):
        aug = RandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=GRID)
        policy = aug.draw_policy(gen, BATCH, GRID, GRID)
        flip = torch.rand(BATCH, generator=gen) < 0.5
        y, c = coeffs(BATCH, GRID)
        kw = dict(ops_list=list(auglist), num_ops=2, magnitude=3)
        err = compare(tag, y, c, policy, flip, **kw)
        max_err = max(max_err, err)
        print(f"kernels: fused_flip_aug_range {tag} drawn at ({BATCH}, {GRID}x{GRID}): max abs "
              f"err {err:.3e}", flush=True)
    # timed with the last (the ViT-Ti) policy already on the card
    policy, flip = tuple(p.cuda() for p in policy), flip.cuda()
    ms = time_ms(lambda: fused_flip_aug_range(y, c, policy, flip, **kw))
    plain_ms = time_ms(lambda: flip_aug_range_plain(y, c, policy, flip, **kw), reps=10, warmup=2)
    # y and c read once and written once; per coefficient the entry clamp,
    # a multiply and a clamp per round and ToRange's multiply-add
    elements = y.numel() + c.numel()
    t_bytes = 2 * elements * 4 / PEAK_BYTES_PER_S
    t_ops = elements * (4 + 3 * kw["num_ops"]) / PEAK_F32_FLOP_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    print(f"kernels: fused_flip_aug_range ({BATCH}, {GRID}x{GRID}) {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), no library call",
          flush=True)
    return {
        "name": "fused_flip_aug_range", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/augpipe.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/augpipe.py:345",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {"fused_attention": kernel_attention_fwd(gen)}
    report["fused_attention_bwd"] = kernel_attention_bwd(gen)
    report["fused_flip_aug_range"] = kernel_augpipe()
    return report


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

    trainer.evaluate(batches)  # warm-up: cuBLAS handles, allocator, pinned pool
    wrappers = {"fused_attention": fused_attention}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = trainer.evaluate(batches)  # ends in a host read of every sum
    eval_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        report[name]["launches"] = count
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


def phase_breakdown(trainer, batch: dict) -> None:
    """Where one eval step's time goes on the card: CUDA-event medians of
    each stage, and the device time of one forward by kernel, from
    ``torch.profiler`` (reported as not measured where it sees none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.train.steps import eval_sums

    model = trainer.model
    with torch.inference_mode():
        upload_ms = time_ms(lambda: trainer.put_batch(batch), reps=10, warmup=2)
        packed = trainer.put_batch(batch)["packed"]
        pipe_ms = time_ms(lambda: trainer.eval_pipe(packed), reps=10, warmup=2)
        y, c, labels, weights = trainer.eval_pipe(packed)
        fwd_ms = time_ms(lambda: model(y, c), reps=20, warmup=3)
        logits = model(y, c)
        sums_ms = time_ms(lambda: eval_sums(logits, labels, weights), reps=10, warmup=2)
        print(f"breakdown: per batch of {BATCH}: upload (pin + copy) {upload_ms:.3f} ms, "
              f"pipeline {pipe_ms:.3f} ms, forward {fwd_ms:.3f} ms "
              f"({BATCH / fwd_ms * 1e3:.1f} img/s), sums {sums_ms:.3f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(y, c)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print("breakdown: torch.profiler saw no device time, kernels not measured")
        return
    print(f"breakdown: forward device time {total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"breakdown: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def phase_train(report: dict):
    """The train step at full width: launch counts, finite losses and the
    loss falling over 20 steps on one repeated batch (warmup 1, lr 3e-3).
    256 images with labels ``arange % 1000`` leave 744 classes unused, whose
    logits alone make the loss fall from ln 1000."""
    import torch

    from rgbnomore_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from rgbnomore_tpu_torch.ops.augpipe import fused_flip_aug_range
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
                "fused_flip_aug_range": fused_flip_aug_range}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.train_step(packed))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        report[name]["launches"] = count
    want = {"fused_flip_aug_range": TRAIN_STEPS, "fused_attention": 12 * TRAIN_STEPS,
            "fused_attention_bwd": 12 * TRAIN_STEPS}
    check(launches == want, f"train launches {launches}, want {want}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    print(f"train: {TRAIN_STEPS} steps of {BATCH} in {train_s:.3f} s, "
          f"{TRAIN_STEPS * BATCH / train_s:.1f} img/s (pipeline + step, one resident batch) | "
          f"launches {launches} | loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    print(f"train: losses {[round(v, 4) for v in losses]}", flush=True)
    return trainer, packed, rows


def phase_train_vs_cpu(rows: np.ndarray) -> None:
    """One step's loss and gradients on the card (kernels) against the CPU
    (plain versions), from the same seeded parameters, rows and draws, at
    full width on 8 images.  Tolerance: float32 sums in other orders (cuBLAS
    against the CPU's GEMMs, the kernels' tiles against einsum) through 12
    blocks and back; a parameter is held to GRAD_RTOL of the largest
    gradient entry in the model, so the key third of each qkv bias, whose
    gradient is zero in exact arithmetic and rounding noise here, is held
    to that noise's scale."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=CPU_GRAD_BATCH, seed=SEED)
    card, cpu = Trainer(cfg, device="cuda"), Trainer(cfg, device="cpu")
    rows = rows[:CPU_GRAD_BATCH]
    draws = cpu.draw(CPU_GRAD_BATCH)
    loss_card = float(card.compute_grads(card.put_batch({"packed": rows})["packed"], draws))
    loss_cpu = float(cpu.compute_grads(torch.from_numpy(rows), draws))
    grads_card = {n: p.grad.cpu() for n, p in card.model.named_parameters()}
    grads_cpu = {n: p.grad for n, p in cpu.model.named_parameters()}
    norm_card = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_card.values()])))
    norm_cpu = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_cpu.values()])))
    gmax = max(float(g.abs().max()) for g in grads_cpu.values())
    worst = max(((float((grads_card[n] - g).abs().max()) / gmax, n)
                 for n, g in grads_cpu.items()))
    rel = {n: float((grads_card[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in grads_cpu.items()}
    worst_own = max((v, n) for n, v in rel.items() if not n.endswith("qkv.bias"))
    print(f"train: card vs CPU at {CPU_GRAD_BATCH} images: loss {loss_card:.7f} vs "
          f"{loss_cpu:.7f}, grad norm {norm_card:.7f} vs {norm_cpu:.7f}, worst gradient "
          f"err {worst[0]:.3e} of the largest entry ({worst[1]}), worst relative to its own "
          f"largest entry {worst_own[0]:.3e} ({worst_own[1]})", flush=True)
    check(abs(loss_card - loss_cpu) <= LOSS_RTOL * abs(loss_cpu),
          f"loss card {loss_card} vs CPU {loss_cpu} beyond rtol {LOSS_RTOL}")
    check(abs(norm_card - norm_cpu) <= GRAD_RTOL * norm_cpu,
          f"grad norm card {norm_card} vs CPU {norm_cpu} beyond rtol {GRAD_RTOL}")
    check(worst[0] <= GRAD_RTOL,
          f"gradient of {worst[1]}: err {worst[0]} of the largest entry, beyond {GRAD_RTOL}")


def phase_train_breakdown(trainer, packed) -> None:
    """Where one train step's time goes on the card: CUDA-event medians of
    its stages (as ``Trainer.train_step`` runs them), and the device time of
    one step by kernel from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.train.steps import mixup_batch, softmax_cross_entropy

    stages = ("pipeline", "forward", "backward", "optimizer")
    times = {s: [] for s in stages}
    classes = trainer.cfg.model.classes
    for _ in range(10):
        draws = trainer.draw(BATCH)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        y, c, labels, _ = trainer.train_pipe(packed, draws.flip, draws.policy)
        ev[1].record()
        (y, c), targets = mixup_batch((y, c), labels, classes, draws.lam)
        loss = softmax_cross_entropy(trainer.model(y, c), targets)
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
    print("breakdown: train step of " + str(BATCH) + ": " + ", ".join(
        f"{s} {med[s]:.3f} ms" for s in stages) + f"; sum {total:.3f} ms "
        f"({BATCH / total * 1e3:.1f} img/s)", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(packed)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_total = sum(e.self_device_time_total for e in events)
    if not dev_total:
        print("breakdown: torch.profiler saw no device time, kernels not measured")
        return
    print(f"breakdown: train step device time {dev_total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"breakdown: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / dev_total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import rgbnomore_tpu_torch  # noqa: F401  (fails here when run outside a checkout)

    # a float32 reference compares in float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(phase_card(), flush=True)
    phase_build()
    report = phase_kernels()
    trainer, batch = phase_slice(report)
    phase_breakdown(trainer, batch)
    del trainer
    trainer, packed, rows = phase_train(report)
    phase_train_vs_cpu(rows)
    phase_train_breakdown(trainer, packed)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
