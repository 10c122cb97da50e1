"""Dynamic loss scaling for fp16 mixed precision, written by hand.

Port of ``rgbnomore_tpu/train/scaler.py``, the reference's
``torch.cuda.amp.GradScaler(growth_factor=1.6, backoff_factor=0.625,
growth_interval=600)`` (``pipeline_utils.py:540-541``) with its scale
clamped to ``[2**-4, 2**18]`` every step (``clip_gradscaler``,
``pipeline_utils.py:399-409``), started at 2**15.  ``torch.amp.GradScaler``
is not it: it starts at 2**16, has no clamp, and skips by its own rule.

In a train step (``Trainer.train_step``):

- the loss is multiplied by ``scale`` before the backward pass, so small
  fp16 gradients do not underflow;
- the gradients are divided by it before the clip and AdamW;
- a non-finite gradient SKIPS the update (``Optimizer.step(finite)``: no
  clip, no AdamW step, so the moments and Adam's count stay) while the
  schedule's count still advances, as the reference's unconditional
  ``scheduler.step()`` (``train.py:174``) and the JAX package's
  ``select_opt_state`` do; the scale backs off;
- ``growth_interval`` finite steps in a row grow the scale.

The state is two 0-d tensors on the device, updated without a branch, as
the JAX package updates it inside its jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch

__all__ = [
    "BACKOFF",
    "GROWTH",
    "GROWTH_INTERVAL",
    "INIT_SCALE",
    "LossScaleState",
    "SCALE_MAX",
    "SCALE_MIN",
    "all_finite",
    "init_loss_scale",
    "update_loss_scale",
]

GROWTH = 1.6
BACKOFF = 0.625
GROWTH_INTERVAL = 600
SCALE_MIN = 2.0**-4
SCALE_MAX = 2.0**18
INIT_SCALE = 2.0**15  # GradScaler's 2**16 would clamp-grow anyway; one doubling of headroom


@dataclass
class LossScaleState:
    """The scaler's state: the current scale (0-d float32) and the finite
    steps in a row since it last changed (0-d int32), on one device."""

    scale: torch.Tensor
    good_steps: torch.Tensor


def init_loss_scale(init_scale: float = INIT_SCALE, device=None) -> LossScaleState:
    """A fresh scaler state on ``device`` (default: the CPU)."""
    return LossScaleState(
        scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
    )


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: True iff every element of every tensor is finite
    (True for none)."""
    flags = [torch.isfinite(t).all() for t in tensors]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def update_loss_scale(state: LossScaleState, finite: torch.Tensor,
                      growth: float = GROWTH, backoff: float = BACKOFF,
                      growth_interval: int = GROWTH_INTERVAL, scale_min: float = SCALE_MIN,
                      scale_max: float = SCALE_MAX) -> LossScaleState:
    """GradScaler.update() semantics: back off on a non-finite step, grow
    after ``growth_interval`` finite steps in a row, clamp to
    ``[scale_min, scale_max]``.  ``finite`` is a 0-d bool tensor; nothing
    here reads it on the host."""
    finite = finite.to(state.scale.device)
    good = torch.where(finite, state.good_steps + 1, 0)
    grow_now = finite & (good >= growth_interval)
    scale = torch.where(finite, torch.where(grow_now, state.scale * growth, state.scale),
                        state.scale * backoff)
    scale = torch.clamp(scale, scale_min, scale_max)
    good = torch.where(grow_now, 0, good)
    return LossScaleState(scale=scale, good_steps=good.to(torch.int32))
