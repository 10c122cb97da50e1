"""The train step's mixup and loss, and the eval step's weighted sums.

Port of ``rgbnomore_tpu/train/steps.py``: ``mixup_batch`` :39-51,
``softmax_cross_entropy`` :54-57, ``make_eval_step`` :103-124 and
``merge_eval_metrics`` :133-139.  Loss semantics mirror the reference
(``train.py:142-176``): cross-entropy on (possibly mixup-softened) one-hot
targets.  Eval mirrors ``eval.py:8-51`` with padded batches + example
weights in place of its no-padding sampler, so the sums are exact under
fixed batch shapes.

The mixup lambda is drawn on its own (:func:`draw_mixup_lambda`) and
handed to :func:`mixup_batch`, so a test can hand over the JAX-drawn one.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["draw_mixup_lambda", "eval_sums", "merge_eval_metrics", "mixup_batch",
           "softmax_cross_entropy"]


def draw_mixup_lambda(rng: np.random.Generator, alpha: float) -> float:
    """One batch's lambda with big_vision's sorted convention: u ~
    Beta(alpha, alpha), then the larger of (u, 1-u), so the original
    example dominates.  Drawn on the host from a seeded numpy generator."""
    u = np.float32(rng.beta(alpha, alpha))
    return float(max(u, np.float32(1.0) - u))


def mixup_batch(inputs: tuple, labels: torch.Tensor, num_classes: int, lam: float,
                roll=None):
    """Batch-level mixup with a given ``lam``: pairs are formed by rolling
    the batch by one (``utils/cls_transforms.py:100-182``).  Returns
    ``(mixed_inputs, mixed_targets)``; the targets are float32 (B, classes).
    ``roll`` rolls a tuple of batches by one: ``torch.roll`` by default;
    the data-parallel trainer passes ``parallel.ring_roll``, which rolls the
    global batch across the ranks as the JAX mixup rolls it."""
    targets = torch.nn.functional.one_hot(labels.to(torch.int64), num_classes).to(torch.float32)
    if roll is None:
        rolled = tuple(torch.roll(x, 1, dims=0) for x in (*inputs, targets))
    else:
        rolled = roll((*inputs, targets))
    mixed = tuple(lam * x + (1.0 - lam) * r for x, r in zip(inputs, rolled))
    return mixed, lam * targets + (1.0 - lam) * rolled[-1]


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against (soft) target distributions, in float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


def eval_sums(logits: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-batch ``(correct, loss_sum, count)`` as 0-d tensors on the logits'
    device; padded examples carry weight 0.  ``labels`` are the wire's
    int32 labels."""
    logits = logits.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    per_example_loss = -logp.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    pred = torch.argmax(logits, dim=-1).to(labels.dtype)
    return {
        "correct": ((pred == labels) * weights).sum(),
        "loss_sum": (per_example_loss * weights).sum(),
        "count": weights.sum(),
    }


def merge_eval_metrics(batches: list[dict[str, Any]]) -> dict[str, float]:
    """Aggregate per-batch eval sums into accuracy / mean loss."""
    correct = float(sum(float(b["correct"]) for b in batches))
    loss_sum = float(sum(float(b["loss_sum"]) for b in batches))
    count = float(sum(float(b["count"]) for b in batches))
    count = max(count, 1.0)
    return {"accuracy": correct / count, "loss": loss_sum / count, "count": count}
