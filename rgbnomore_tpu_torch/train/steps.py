"""The eval step's weighted sums and their merge.

Port of the eval half of ``rgbnomore_tpu/train/steps.py`` (``make_eval_step``
:103-124, ``merge_eval_metrics`` :133-139), which mirrors the reference's
``eval.py:8-51`` with padded batches + example weights in place of its
no-padding sampler, so the sums are exact under fixed batch shapes.  The
train step comes with the train slice.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["eval_sums", "merge_eval_metrics"]


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
