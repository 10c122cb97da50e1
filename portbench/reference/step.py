"""Plain reference of the train step and the eval sums.

A train step: the wire's decode of the rows, the input stage
(``augment.train_stage``), mixup with the batch rolled by one, the forward,
the mean soft-target cross-entropy, the backward, the global-norm clip (optax's formula) and AdamW with decoupled
weight decay on the Linear weights, at the warmup-cosine learning rate of
the step count.  The batch runs through the model in blocks of rows, each
block's share of the mean loss back-propagated in turn, so that a batch of
any size fits; that changes only the order of float32 sums.

An eval batch: the decode, the eval stage, the forward, and the weighted
sums (correct, loss_sum, count), summed in float64.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference import augment

__all__ = ["AdamW", "eval_sums", "lr_at", "train_steps"]


def lr_at(step: int, base_lr: float, warmup: int, total: int) -> float:
    """Linear warmup ``base_lr * (step + 1) / warmup``, then cosine to 0
    over the remaining steps, in float32."""
    f = np.float32
    s = f(step)
    if s < warmup:
        return float(f(base_lr) * (s + f(1.0)) / f(max(1, warmup)))
    progress = np.clip((s - f(warmup)) / f(max(1, total - warmup)), f(0.0), f(1.0))
    return float(f(base_lr) * f(0.5) * (f(1.0) + np.cos(f(math.pi) * progress)))


class AdamW:
    """AdamW written out: decay ``p *= 1 - lr * wd`` on the decayed leaves,
    then ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, named: list, decayed: set, wd: float, b1=0.9, b2=0.999, eps=1e-8):
        self.named, self.decayed, self.wd = named, decayed, wd
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {n: torch.zeros_like(p) for n, p in named}
        self.v = {n: torch.zeros_like(p) for n, p in named}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.named:
            g = p.grad
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            if n in self.decayed:
                p.mul_(1.0 - lr * self.wd)
            denom = (self.v[n] / c2).sqrt().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def decayed_names(model: torch.nn.Module) -> set:
    """The weights of Linear layers."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


@torch.no_grad()
def clip_(grads: list, max_norm: float) -> torch.Tensor:
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


TRAIN_KEYS = {"batch_size", "epochs", "steps_per_epoch", "lr", "wd", "warmup", "clip_norm",
              "auglist", "num_ops", "augstr", "augmax", "mixup_alpha", "amp", "drop"}
AMBIGUOUS = 1e-3  # a top-2 logit margin under this may flip with round-off


def check_train(t: dict) -> None:
    """Raise where the ``train`` section asks for what this reference does
    not model: an unknown key, dropout, or another count of magnitude bins."""
    unknown = set(t) - TRAIN_KEYS
    if unknown:
        raise ValueError(f"the reference step does not model train keys {sorted(unknown)}")
    if t["drop"] != 0.0:
        raise ValueError(f"the reference step has no dropout (drop {t['drop']})")
    if t["augmax"] != augment.NUM_BINS - 1:
        raise ValueError(f"the reference's RandAugment table has {augment.NUM_BINS} bins, "
                         f"not augmax + 1 = {t['augmax'] + 1}")


def train_steps(model, steps: list, cfg: dict, decode, *, block: int, total_steps: int,
                lost_rows: int = 0, wrong_label: bool = False) -> dict:
    """Run ``steps`` (each ``(rows (B, row) uint8 on the model's device,
    draws)``) as train steps from the model's weights; ``decode(rows)`` is
    the wire's reading of the rows, ``(y, c, labels, weights)``.  Returns the
    loss of each step, each leaf's gradient norm as the first update saw it
    (after the clip), and each leaf's change over all the steps.

    ``lost_rows`` drops that many rows from the end of every batch (the
    mean over the rest), ``wrong_label`` gives the first row another label:
    the faults that the check has to catch."""
    t = cfg["train"]
    check_train(t)
    named = list(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    opt = AdamW(named, decayed_names(model), t["wd"] / t["lr"])
    model.train()
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    classes = cfg["model"]["classes"]
    for i, (rows, draws) in enumerate(steps):
        y, c, labels, _ = decode(rows)
        y, c = augment.train_stage(y, c, draws["flip"], draws["policy"], t["auglist"],
                                   t["augstr"])
        keep = draws.get("drop_keep")
        keep = None if keep is None else keep.to(y.device)
        if lost_rows:
            n = y.shape[0] - lost_rows
            y, c, labels = y[:n], c[:n], labels[:n]
            keep = None if keep is None else keep[..., :n]
        labels = labels.to(torch.int64)
        if wrong_label:
            labels = labels.clone()
            labels[0] = (labels[0] + 1) % classes
        lam = draws["lam"]
        onehot = F.one_hot(labels, classes).to(torch.float32)
        y = lam * y + (1.0 - lam) * torch.roll(y, 1, 0)
        c = lam * c + (1.0 - lam) * torch.roll(c, 1, 0)
        target = lam * onehot + (1.0 - lam) * torch.roll(onehot, 1, 0)
        for _, p in named:
            p.grad = None
        b = y.shape[0]
        loss = torch.zeros((), dtype=torch.float64, device=y.device)
        for s in range(0, b, block):
            rows_ = slice(s, min(s + block, b))
            kb = None if keep is None else keep[..., rows_]
            logp = torch.log_softmax(model(y[rows_], c[rows_], kb).float(), dim=-1)
            part = -torch.sum(target[rows_] * logp) / b
            part.backward()
            loss += part.detach().double()
        out["loss"].append(float(loss))
        grads = [p.grad for _, p in named]
        clip_(grads, t["clip_norm"])
        if i == 0:
            out["grad_norm"] = {n: float(p.grad.double().norm()) for n, p in named}
        opt.step(lr_at(i, t["lr"], t["warmup"], total_steps))
    out["change_norm"] = {n: float((p.detach() - start[n]).double().norm()) for n, p in named}
    return out


@torch.no_grad()
def eval_sums(model, rows: torch.Tensor, cfg: dict, decode, *, block: int,
              lost_rows: int = 0, wrong_label: bool = False, miscount: bool = False) -> dict:
    """(correct, loss_sum, count) of one eval batch, summed in float64, and
    ``ambiguous``: the weight of the rows whose label is one of two classes
    whose logits lie within ``AMBIGUOUS`` of each other at the top, so that
    round-off may move the row's top-1 either way.  ``miscount`` adds one to
    the top-1 tally (a fault the check has to catch)."""
    model.eval()
    y, c, labels, weights = decode(rows)
    y, c = augment.eval_stage(y, c)
    if lost_rows:
        n = y.shape[0] - lost_rows
        y, c, labels, weights = y[:n], c[:n], labels[:n], weights[:n]
    labels = labels.to(torch.int64)
    if wrong_label:
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % cfg["model"]["classes"]
    correct = loss_sum = ambiguous = 0.0
    for s in range(0, y.shape[0], block):
        r = slice(s, s + block)
        logits = model(y[r], c[r]).float()
        logp = torch.log_softmax(logits, dim=-1)
        w = weights[r].double()
        correct += float(((logits.argmax(-1) == labels[r]).double() * w).sum())
        loss_sum += float((-logp.gather(-1, labels[r, None])[:, 0].double() * w).sum())
        top = logits.topk(2, dim=-1)
        near = (top.values[:, 0] - top.values[:, 1]) < AMBIGUOUS
        ambiguous += float(((near & (top.indices == labels[r, None]).any(-1)).double()
                            * w).sum())
    return {"correct": correct + float(miscount), "loss_sum": loss_sum,
            "count": float(weights.double().sum()), "ambiguous": ambiguous}
