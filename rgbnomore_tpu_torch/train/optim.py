"""Optimizer and schedule: global-norm clip, then AdamW with schedule-scaled
decoupled weight decay on kernels only (PyTorch).

Port of ``rgbnomore_tpu/train/optim.py``.  The reference trains with a
decay-free AdamW plus a separate ``WeightDecay`` step ``p -= (lr/base_lr) *
wd * p`` on parameters named ``*.weight`` excluding LayerNorms
(``pipeline_utils.py:518-543``, ``custom_optims.py:37-43``).  The JAX package
collapses that into optax's ``adamw`` with ``weight_decay = wd / base_lr``
and a kernel-only mask; here it is ``torch.optim.AdamW`` with two parameter
groups — Linear weights with that decay, everything else without — and the
scheduled learning rate set before each step.  Both apply ``lr * (adam +
weight_decay * p)`` per step, with eps outside the square root.

Schedule (``train.py:150-176``): linear warmup ``LR*(step+1)/warmup`` for
``warmup`` steps, then per-iteration cosine decay to 0 over the rest.  The
global-norm clip precedes the optimizer with optax's formula.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["Optimizer", "clip_by_global_norm", "decay_parameter_names",
           "warmup_cosine_schedule"]


def warmup_cosine_schedule(base_lr: float, warmup: int, total_steps: int):
    """lr(step): LR*(step+1)/warmup, then cosine LR -> 0 over the remainder.
    Computed in float32, as the JAX schedule is."""
    decay_steps = max(1, total_steps - warmup)
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = f32(base_lr) * (s + f32(1.0)) / f32(max(1, warmup))
        progress = np.clip((s - f32(warmup)) / f32(decay_steps), f32(0.0), f32(1.0))
        cos = f32(base_lr) * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * progress))
        return float(warm if s < warmup else cos)

    return schedule


def decay_parameter_names(model: nn.Module) -> set[str]:
    """Names of the parameters that take weight decay: the weights of Linear
    layers (the flax ``kernel`` leaves; the reference's ``*.weight`` minus
    norms).  Biases and LayerNorm scales and shifts take none."""
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``, as optax does: unchanged when the norm is below it, else
    ``g / norm * max_norm``.  Returns the norm before clipping, on the
    device (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class Optimizer:
    """Global-norm clip, then AdamW on two parameter groups, with the
    warmup-cosine learning rate of the step count before the update (as
    optax's schedule is read).  ``count`` is the schedule's count: the
    steps taken, skipped ones included (fp16 loss scaling); AdamW's own
    per-parameter ``step`` counts the updates made."""

    def __init__(self, model: nn.Module, base_lr: float, weight_decay: float, warmup: int,
                 total_steps: int, clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        decay = decay_parameter_names(model)
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if n in decay],
             "weight_decay": weight_decay / base_lr},
            {"params": [p for n, p in named if n not in decay], "weight_decay": 0.0},
        ]
        self.opt = torch.optim.AdamW(groups, lr=base_lr, betas=(b1, b2), eps=eps,
                                     foreach=True)
        self.schedule = warmup_cosine_schedule(base_lr, warmup, total_steps)
        self.clip_norm = clip_norm
        self.count = 0  # steps taken, the schedule's step

    def step(self, finite: torch.Tensor | None = None) -> torch.Tensor | None:
        """Clip the gradients, update the parameters, advance the count;
        returns the global gradient norm before clipping (on the device).

        ``finite`` (fp16 loss scaling, ``train/scaler.py``) is a 0-d bool
        tensor; where it is False the step is skipped: no clip and no AdamW
        step, so the parameters, the moments and AdamW's count stay as they
        were, and only the schedule's count advances (the reference's
        GradScaler skips ``optimizer.step()`` and still calls
        ``scheduler.step()``); returns None.  The host reads the flag, which
        waits for the backward pass: a selection on the device of every
        parameter, moment and count made the step slower on the card,
        where it waits on the host's enqueue (``tools/fp16_skip_ab.py``,
        PERF.md, PR 7)."""
        if finite is not None and not bool(finite):
            self.count += 1
            return None
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm
