"""Library entry point for evaluation (port of ``evaluate_model``, the JAX
package's ``eval.py:17-22``).  The CLI comes with the trainer slice."""

from __future__ import annotations

from pathlib import Path

import torch

from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.train.config import Config
from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

__all__ = ["evaluate_model"]


def evaluate_model(cfg: Config, index_train: str, index_val: str, loadpath: str = "",
                   *, device=None, num_threads: int = 4) -> dict:
    """Evaluate a ViT on the test (``index_val``), minival and trainval
    splits over the cropped DCT wire.

    ``loadpath`` names a ``state_dict`` saved with ``torch.save`` (see
    ``convert.py`` for weights trained by the JAX package); without it the
    weights are drawn from ``cfg.seed``.  Runs on ``device`` (default
    ``cuda``).  Returns ``{"test": ..., "val": ..., "trainval": ...}``, each
    ``{"accuracy", "loss", "count"}``.
    """
    dev = resolve_device(device)
    trainer = Trainer(cfg, device=dev)
    if loadpath:
        if not Path(loadpath).exists():
            raise FileNotFoundError(f"no weights at {loadpath}")
        state = torch.load(loadpath, map_location=dev, weights_only=True)
        trainer.model.load_state_dict(state)
    loaders = make_loaders(cfg, index_train, index_val, num_threads=num_threads)
    return {
        "test": trainer.evaluate(loaders["test"]),
        "val": trainer.evaluate(loaders["minival"]),
        "trainval": trainer.evaluate(loaders["trainval"]),
    }
