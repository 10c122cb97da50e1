"""Benchmark harness: the six throughput metrics of the reference, the port's
counterpart of ``rgbnomore_tpu/benchmark.py:35-202`` under the same names.

  1/2. train / test dataloader FPS (host decode only);
  3/4. model fwd+bwd / fwd-only FPS on synthetic tensors;
  5/6. train / test full-pipeline FPS (loader + upload + device step).

The semantics are the JAX package's: the first batch (or step) is left out
of the time, the model benchmarks run ``max(N, 300)`` iterations at the
per-device batch, and FPS is this process's images over its seconds (one
process per GPU: multiply by the ranks for a data-parallel run).  Every
span is timed by ``utils.timing.timed``: on the card between two CUDA
events after a synchronise, not at a value read back.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from rgbnomore_tpu_torch import parallel
from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.utils.timing import timed

log = logging.getLogger(__name__)

__all__ = [
    "benchmark_dataloader",
    "benchmark_model",
    "benchmark_model_synthetic",
    "benchmark_pipeline",
]


def benchmark_dataloader(loader, max_iters: int) -> tuple[int, float]:
    """(images, seconds) of ``max_iters`` batches after the first
    (``benchmark.py:10-57``), on the host clock."""
    it = iter(loader)
    if next(it, None) is None:  # first batch excluded
        return 0, 0.0
    return timed(lambda: sum(int(b["weights"].sum()) for b in itertools.islice(it, max_iters)))


def benchmark_model_synthetic(cfg, iters: int, mode: str = "fbp", n_devices: int | None = None,
                              device=None) -> tuple[int, float]:
    """fwd+bwd+update (``"fbp"``) or forward-only images and seconds on
    synthetic inputs from a numpy seed: DCT Y (B, 1, 28, 28, 8, 8) and CbCr
    (B, 2, 14, 14, 8, 8) (``eval.py:114-121``), or RGB (B, 3, S, S)
    (``benchmark.py:59-123``); ``max(iters, 300)`` iterations at the
    per-device batch (``cfg.train.batch_size`` over ``n_devices``, default
    the process group's size) after one untimed.  The fwd+bwd step is the
    model's softmax cross-entropy on one-hot labels, backward, clip and
    AdamW (no mixup), as the JAX package's ``make_train_step(use_mixup=
    False)``, in training mode: each step draws SwinV2's drop-path keep
    masks from a seeded generator, as ``Trainer.draw`` does, and at
    ``cfg.train.drop > 0`` its dropout masks (``DropoutMasks`` on a seeded
    device generator), where JAX hands the step a dropout key
    (``steps.py:89-92``)."""
    from rgbnomore_tpu_torch.models.layers import DropoutMasks
    from rgbnomore_tpu_torch.train.config import build_model, update_runtime
    from rgbnomore_tpu_torch.train.optim import Optimizer
    from rgbnomore_tpu_torch.train.steps import softmax_cross_entropy

    if mode not in ("fbp", "fwd"):
        raise ValueError(f"mode must be 'fbp' or 'fwd', got {mode!r}")
    dev = resolve_device(device)
    cfg = update_runtime(cfg, n_devices or parallel.world_size())
    batch = cfg.train.batch_per_device
    rng = np.random.default_rng(0)
    if cfg.model.domain == "RGB":
        s = cfg.model.input_size
        shapes = [(batch, 3, s, s)]
    else:
        nb = cfg.model.dct_blocks
        shapes = [(batch, 1, nb, nb, 8, 8), (batch, 2, nb // 2, nb // 2, 8, 8)]
    inputs = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
              for sh in shapes]
    labels = torch.from_numpy(rng.integers(0, cfg.model.classes, batch).astype(np.int64))
    labels = labels.to(dev)
    model = build_model(cfg, device=dev)
    iters = max(iters, 300)

    if mode == "fbp":
        optimizer = Optimizer(model, cfg.train.lr, cfg.train.wd, 100, iters)
        targets = torch.nn.functional.one_hot(labels, cfg.model.classes).to(torch.float32)
        model.train()
        rates = getattr(model, "drop_path_rates", None)
        generator = torch.Generator().manual_seed(cfg.seed)
        dropout_generator = (torch.Generator(device=dev).manual_seed(cfg.seed)
                             if cfg.train.drop > 0 else None)

        def draws() -> dict:
            """The step's drop-path keep masks (SwinV2) and dropout masks."""
            extra = {}
            if rates is not None:
                u = torch.rand((len(rates), 2, batch), generator=generator)
                keep = u >= torch.tensor(rates, dtype=u.dtype)[:, None, None]
                extra["drop_keep"] = keep.to(dev, non_blocking=True)
            if dropout_generator is not None:
                extra["dropout"] = DropoutMasks(generator=dropout_generator)
            return extra

        def step():
            loss = softmax_cross_entropy(model(*inputs, **draws()), targets)
            model.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    else:
        model.eval()

        def step():
            with torch.inference_mode():
                model(*inputs)

    step()  # first call (cuBLAS handles, kernel builds) excluded

    def run():
        for _ in range(iters):
            step()

    return batch * iters, timed(run, dev)[1]


def benchmark_pipeline(trainer, loader, iters: int, mode: str = "train") -> tuple[int, float]:
    """Images and seconds of the loader + upload + device step over
    ``iters`` batches after the first (``benchmark.py:290-364``): the
    ``Trainer``'s train step (``mode="train"``, ``create_state`` first) or
    its eval step."""

    def step(batch) -> int:
        if mode == "train":
            trainer.train_step(trainer.upload(batch))
        else:
            with torch.inference_mode():
                trainer.eval_step(trainer.upload(batch))
        return int(batch["weights"].sum())

    it = iter(loader)
    first = next(it, None)
    if first is None:
        return 0, 0.0
    step(first)  # excluded: kernel builds, cuBLAS handles, the loader's start
    return timed(lambda: sum(step(b) for b in itertools.islice(it, iters)), trainer.device)


def benchmark_model(cfg, iters: int, index_train: str, index_val: str, num_threads: int = 4,
                    verbose: int = 1, num_devices: int | None = None,
                    transfer: str | None = None, device=None) -> dict[str, float]:
    """Run all six measurements and log FPS (``eval.py:53-181``); returns
    ``{"train_loader_fps", "test_loader_fps", "model_fbp_fps",
    "model_fwd_fps", "train_pipeline_fps", "test_pipeline_fps"}``, each this
    process's img/s.

    ``verbose``: 0 silent, 1 the final table, 2 also each measurement's
    images and seconds.  ``transfer`` defaults to ``"cropped"``;
    ``num_devices`` to the process group's size.  ``device`` defaults to
    ``cuda``."""
    from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

    transfer = transfer or "cropped"
    trainer = Trainer(cfg, device=device, transfer=transfer)
    loaders = make_loaders(cfg, index_train, index_val, num_threads=num_threads,
                           global_batch=trainer.global_batch(), transfer=transfer,
                           packed_k=trainer.packed_k,
                           packed_k_eval=trainer.packed_k_eval, eval_fmt=trainer.eval_fmt,
                           train_fmt=trainer.train_fmt)
    trainer.create_state(max(1, len(loaders["train"])))
    n_dev = num_devices or parallel.world_size()

    results: dict[str, float] = {}

    def record(name: str, n: int, dt: float) -> None:
        results[name] = n / dt if dt else 0.0
        if verbose >= 2:
            log.info("%s: %d imgs in %.2fs", name, n, dt)

    record("train_loader_fps", *benchmark_dataloader(loaders["train"], iters))
    record("test_loader_fps", *benchmark_dataloader(loaders["test"], iters))
    record("model_fbp_fps", *benchmark_model_synthetic(cfg, iters, "fbp", n_devices=n_dev,
                                                       device=trainer.device))
    record("model_fwd_fps", *benchmark_model_synthetic(cfg, iters, "fwd", n_devices=n_dev,
                                                       device=trainer.device))
    record("train_pipeline_fps", *benchmark_pipeline(trainer, loaders["train"], iters, "train"))
    record("test_pipeline_fps", *benchmark_pipeline(trainer, loaders["test"], iters, "test"))

    if verbose >= 1:
        for k, v in results.items():
            log.info("%s: %.1f img/s (this process)", k, v)
    return results
