"""Headline benchmark of the port: JPEG ViT-Ti DCT training throughput on one
GPU, the counterpart of the JAX package's ``bench.py:44-177``.

    python -m rgbnomore_tpu_torch.bench [--device cuda|cpu]

It writes 512 synthetic 512x512 JPEGs with the port's codec (the JAX
bench's sinusoids from seed 0) into a temporary directory, then trains the
``vitti`` preset (weights from ``init_weights`` with seed 0) at batch 256
from ``DctCroppedLoader`` (prefetch 4) through ``Trainer.train_step``: the
whole path, host JPEG decode -> upload -> device pipeline -> forward,
backward and AdamW.  It skips 5 steps, times 7 windows of 10 steps and
reports the median window's img/s; beside it the device-only rate of 20
steps on one resident batch.  ``RGBNM_BENCH_THREADS`` sets the loader's
threads (default 2) and ``RGBNM_BENCH_AMP`` an AMP dtype (``bf16``,
``fp16``; default float32).

It prints ONE JSON line: ``metric``, ``value``, ``unit``,
``device_step_imgs_per_sec``, ``n_gpus`` and ``device`` (the card's name
and power limit as ``nvidia-smi`` gives them).  On failure it prints a JSON
line with ``error`` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

METRIC = "jpeg_vitti_train_pipeline_imgs_per_sec_per_gpu"
BATCH = 256
N_IMAGES = 2 * BATCH  # more than one batch: the train loader drops the last partial one
IMAGE_SIZE = 512
SKIP, WINDOWS, PER_WINDOW, DEVICE_STEPS = 5, 7, 10, 20


def make_synthetic_dataset(root: Path, n: int, size: int = IMAGE_SIZE) -> Path:
    """Write ``n`` synthetic ``size`` x ``size`` JPEGs (three phase-shifted
    sinusoids of random frequency, quality 90, labels ``i % 1000``) and
    their index CSV under ``root``; returns the index's path."""
    from rgbnomore_tpu_torch import codec

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:size, 0:size]
    rows = ["Filepath,Label"]
    for i in range(n):
        f = 0.02 + 0.03 * rng.random(2)
        img = np.stack([(128 + 100 * np.sin(ys * f[0] + p) * np.cos(xs * f[1])).astype(np.uint8)
                        for p in (0.0, 1.0, 2.0)])
        path = root / f"img_{i}.jpg"
        codec.write_tensor(path, img, quality=90)
        rows.append(f"{path},{i % 1000}")
    index = root / "index.csv"
    index.write_text("\n".join(rows) + "\n")
    return index


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (``"cpu"`` on the
    CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def run_bench(cfg, index: Path, *, device=None, threads: int = 2) -> dict:
    """Measure the train pipeline of ``cfg`` on the JPEGs of ``index`` (``SKIP``
    steps, then ``WINDOWS`` windows of ``PER_WINDOW`` steps, then
    ``DEVICE_STEPS`` on a resident batch) and print the one JSON line;
    returns it as a dict."""
    import torch

    from rgbnomore_tpu_torch.data.index import load_index
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader
    from rgbnomore_tpu_torch.train.loop import Trainer
    from rgbnomore_tpu_torch.utils.timing import timed, timeit_fifo

    trainer = Trainer(cfg, device=device)
    dev = trainer.device
    loader = DctCroppedLoader(load_index(index), trainer.global_batch(),
                              target=cfg.model.dct_blocks, k=trainer.packed_k, mode="train",
                              shuffle=True, drop_last=True, seed=0, num_threads=threads,
                              prefetch=4)
    if len(loader) == 0:
        raise RuntimeError("the benchmark loader gives no batch: fewer images than the batch")
    trainer.create_state(max(1, len(loader)))

    it = loader.iter_cycle(SKIP + WINDOWS * PER_WINDOW)
    for _ in range(SKIP):  # kernel builds, cuBLAS handles, the loader's first batches
        trainer.train_step(trainer.upload(next(it)))

    def window() -> int:
        n = 0
        for _ in range(PER_WINDOW):
            batch = next(it)
            trainer.train_step(trainer.upload(batch))
            n += batch["labels"].shape[0]
        return n

    rates = sorted(n / dt for n, dt in (timed(window, dev) for _ in range(WINDOWS)))

    # the device-only rate: one resident batch, no loader
    batch = next(iter(loader))
    resident = trainer.upload(batch)
    step_s = timeit_fifo(trainer.train_step, (resident,), depth=DEVICE_STEPS, repeats=1,
                         warmup=1)
    device_rate = batch["labels"].shape[0] / step_s

    out = {
        "metric": METRIC,
        "value": round(rates[len(rates) // 2], 1),
        "unit": "imgs/sec/gpu",
        "device_step_imgs_per_sec": round(device_rate, 1),
        "n_gpus": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device": card_name(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m rgbnomore_tpu_torch.bench",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    try:
        from rgbnomore_tpu_torch.train.config import generate_config

        amp = os.environ.get("RGBNM_BENCH_AMP", "")
        threads = int(os.environ.get("RGBNM_BENCH_THREADS", "2"))
        cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=0,
                              amp=True if amp else None, ampdtype=amp or None)
        with tempfile.TemporaryDirectory() as tmp:
            run_bench(cfg, make_synthetic_dataset(Path(tmp), N_IMAGES), device=args.device,
                      threads=threads)
    except Exception as exc:  # one JSON line, whatever failed
        print(json.dumps({"metric": METRIC, "error": f"{type(exc).__name__}: {exc}"}),
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
