"""Checkpoints of the whole training state, one ``torch.save`` file per epoch.

The port's counterpart of ``rgbnomore_tpu/train/checkpoint.py:21-62``
(Orbax there).  A checkpoint holds what a resumed run needs to continue as
if it had never stopped:

- the model's ``state_dict``;
- the AdamW state (``Optimizer.opt.state_dict()``: moments and Adam's
  count) and the schedule's count (``Optimizer.count``);
- the fp16 loss scaler's state (``Trainer.loss_scale``), or None;
- the epoch and its metrics;
- the state of the Trainer's two host generators, ``Trainer.generator``
  (flip, policy, drop path) and ``Trainer.rng`` (mixup's lambda).  The JAX
  step draws from a key folded with the step count, so its resume needs no
  generator; the port's draws advance stateful generators, and a resume
  that did not restore them would be a different run.  Dropout needs
  nothing: its device generator is seeded from ``(cfg.seed, step, rank)``
  each step (``Trainer.dropout_masks``).

Files are ``<dir(savepath)>/checkpoints/<model>/epoch_<N>.pt``, written to
a temporary file and renamed, by rank 0 only, then a barrier; every rank
reads them.  They load with ``weights_only=True``: tensors, numbers,
strings and containers, numpy's PCG64 state as a dict of Python ints.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from rgbnomore_tpu_torch.parallel import barrier, is_rank0
from rgbnomore_tpu_torch.train.scaler import LossScaleState

__all__ = ["checkpoint_dir", "latest_checkpoint_step", "restore_checkpoint", "save_checkpoint"]

_NAME = re.compile(r"epoch_(\d+)\.pt")


def checkpoint_dir(savepath: str, model_name: str) -> Path:
    """``<dir(savepath)>/checkpoints/<model>`` as in ``pipeline_utils.py:471-488``."""
    return Path(savepath).resolve().parent / "checkpoints" / model_name


def _path(ckpt_dir: str | Path, epoch: int) -> Path:
    return Path(ckpt_dir).resolve() / f"epoch_{epoch}.pt"


def save_checkpoint(ckpt_dir: str | Path, trainer, epoch: int,
                    metrics: dict[str, Any] | None = None) -> Path:
    """Save ``trainer``'s training state and ``{epoch, metrics}`` as the
    checkpoint of ``epoch``; returns its path.  Every rank calls it."""
    path = _path(ckpt_dir, epoch)
    if is_rank0():
        if trainer.optimizer is None:
            raise RuntimeError("call create_state before save_checkpoint")
        bitgen = trainer.rng.bit_generator.state
        state = {
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.opt.state_dict(),
            "count": int(trainer.optimizer.count),
            "loss_scale": None if trainer.loss_scale is None else {
                "scale": trainer.loss_scale.scale, "good_steps": trainer.loss_scale.good_steps},
            "generator": trainer.generator.get_state(),
            "rng": {"bit_generator": str(bitgen["bit_generator"]),
                    "state": int(bitgen["state"]["state"]), "inc": int(bitgen["state"]["inc"]),
                    "has_uint32": int(bitgen["has_uint32"]),
                    "uinteger": int(bitgen["uinteger"])},
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
    barrier()
    return path


def latest_checkpoint_step(ckpt_dir: str | Path) -> int | None:
    """The last epoch with a checkpoint under ``ckpt_dir``, or None."""
    path = Path(ckpt_dir).resolve()
    if not path.is_dir():
        return None
    epochs = [int(m.group(1)) for p in path.iterdir() if (m := _NAME.fullmatch(p.name))]
    return max(epochs, default=None)


def restore_checkpoint(ckpt_dir: str | Path, trainer, step: int | None = None) -> dict:
    """Load the checkpoint of epoch ``step`` (default: the latest) into
    ``trainer``, whose ``create_state`` has run; returns ``{"epoch",
    "metrics"}``."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoints under {Path(ckpt_dir).resolve()}")
    if trainer.optimizer is None:
        raise RuntimeError("call create_state before restore_checkpoint")
    # onto the CPU: AdamW keeps its count there (capturable=False), and
    # load_state_dict moves the moments to the parameters' device
    state = torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.opt.load_state_dict(state["optimizer"])
    trainer.optimizer.count = state["count"]
    scale = state["loss_scale"]
    trainer.loss_scale = None if scale is None else LossScaleState(
        scale=scale["scale"].to(trainer.device), good_steps=scale["good_steps"].to(trainer.device))
    trainer.generator.set_state(state["generator"])
    rng = state["rng"]
    trainer.rng.bit_generator.state = {
        "bit_generator": rng["bit_generator"],
        "state": {"state": rng["state"], "inc": rng["inc"]},
        "has_uint32": rng["has_uint32"], "uinteger": rng["uinteger"]}
    return {"epoch": state["epoch"], "metrics": state["metrics"]}
