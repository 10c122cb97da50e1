#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``rgbnomore_tpu_torch/csrc/``
with ``nvcc`` for ``sm_90a``, holds each kernel against its plain PyTorch
version on the card, then drives the port's main path — full-width ViT-Ti
evaluation over the cropped DCT wire (K=48 ``mask16`` rows, batch 256) —
through ``Trainer.evaluate`` and checks that every kernel of that path was
launched and that what comes out is right.

Phases, each raising on failure (the script then exits non-zero):
  1. card: print ``nvidia-smi --query-gpu=name,power.limit`` for the card;
  2. build: compile the kernels, one ``nvcc`` per source, started together;
  3. kernels: each kernel against its plain version at the main path's
     shapes and the JAX package's test shapes, then timed with CUDA events
     beside its plain version, its bound and a PyTorch library call;
  4. slice: 512 images through ``Trainer.evaluate`` with launch counts; the
     pipeline on the card against the CPU, logits of the kernel path against
     the plain path and against the CPU;
  5. breakdown: the time of each stage of one eval step, and of each kernel
     of one forward (``torch.profiler``).

The host JPEG codec needs libjpeg's headers, which the card machine does not
have, so the slice is fed rows that this script writes itself in the
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


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import attention_plain, fused_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
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
    return {"fused_attention": {
        "name": "fused_attention", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:39",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }}


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
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model(y, c)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        except RuntimeError as exc:  # the profiler is a reading, not a check
            print(f"breakdown: torch.profiler failed, kernels not measured: {exc}")
            return
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print("breakdown: torch.profiler saw no device time, kernels not measured")
        return
    print(f"breakdown: forward device time {total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"breakdown: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:80]}")


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
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
