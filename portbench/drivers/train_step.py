"""Driver of the port's train step: ``Trainer.upload`` + ``Trainer.train_step``.

Each step draws from the seed (flip, RandAugment policy, mixup lambda,
SwinV2's drop-path keep masks) and hands the draws to ``train_step``, so
that the reference can take the same.  Set-up drives the Trainer that the
window then uses through ``CHECK_STEPS`` steps on distinct batches, keeping
what the check compares: each step's loss (the mean over the ranks), each
leaf's gradient norm as AdamW received it (its first moment after one step
over 1 - beta1) and each leaf's change over the steps; then one more step
warms up.  The window's outputs are the steps' losses, read once it has
closed for non-finite ones.  The reference (``reference/step.py``) follows
the check's steps from the same weights on the global batch.

In a process group every rank makes the global draws and keeps its slice.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import check as compare
import inputs
import program
from reference import models as ref_models
from reference import step as ref_step

KIND = "train"
WIRE_K = "train_k"
SHARDS = True  # runs over several ranks, each on its slice of the batch
TRAFFIC_KEYS = {"ranks"}
CHECK_STEPS = 3


def batch(cfg: dict, traffic: dict) -> int:
    """The global batch: the configuration's."""
    return cfg["train"]["batch_size"]


def _drop_path_rates(m: dict):
    if m["arch"] != "swinv2":
        return None
    return np.linspace(0.0, m["drop_path"], sum(m["depth"])).tolist()


def _next_draws(c) -> dict:
    t = c.cfg["train"]
    return inputs.make_draws(c.state["gen"], c.state["rng"], c.batch, c.grid, t["auglist"],
                             t["num_ops"], t["mixup_alpha"], c.state["rates"])


def _local(c, draws: dict) -> dict:
    if c.world == 1:
        return draws
    keep, mine = draws["drop_keep"], c.mine
    return {"flip": draws["flip"][mine], "policy": tuple(p[mine] for p in draws["policy"]),
            "lam": draws["lam"], "drop_keep": None if keep is None else keep[..., mine]}


def _train(c, i: int, draws: dict):
    return c.trainer.train_step(c.upload(i), program.step_draws(_local(c, draws)))


def _first_grad_norms(trainer) -> dict:
    """Each leaf's gradient as AdamW received it in the first step: its
    first moment over (1 - beta1); 0 where AdamW holds no moment for it."""
    opt = trainer.optimizer.opt
    out = {}
    for name, p in trainer.model.named_parameters():
        group = next(g for g in opt.param_groups if any(q is p for q in g["params"]))
        moment = opt.state[p].get("exp_avg")
        out[name] = torch.zeros((), dtype=torch.float64) if moment is None else \
            torch.linalg.vector_norm(moment.double() / (1.0 - group["betas"][0]))
    return out


def prepare(c) -> int:
    """The check's steps, then one warm-up step; the window's first batch."""
    c.state.update(gen=torch.Generator().manual_seed(inputs.stream_seed(c.seed, "draws")),
                   rng=np.random.default_rng(inputs.stream_seed(c.seed, "mixup")),
                   rates=_drop_path_rates(c.cfg["model"]))
    losses, c.state["check_draws"] = [], []
    for i in range(CHECK_STEPS):
        c.state["check_draws"].append(_next_draws(c))
        losses.append(_train(c, i, c.state["check_draws"][-1]))
        if i == 0:
            grads = _first_grad_norms(c.trainer)
    start = inputs.make_weights(c.seed, ref_models.build(c.cfg["model"], "meta"), c.device)
    with torch.no_grad():
        changes = {n: torch.linalg.vector_norm((p.detach() - start[n]).double())
                   for n, p in c.trainer.model.named_parameters()}
    del start
    losses = c.mean_over_ranks(torch.stack(losses))
    c.mark("check steps")
    c.run.program_out = {"loss": [float(x) for x in losses],
                         "grad_norm": {n: float(v) for n, v in grads.items()},
                         "change_norm": {n: float(v) for n, v in changes.items()}}
    _train(c, CHECK_STEPS, _next_draws(c))
    return CHECK_STEPS + 1


def step(c, i: int):
    """One window step on pool batch ``i``: its loss, not yet read."""
    with c.span("pb.draws"):
        draws = _next_draws(c)
    return _train(c, i, draws)


def window():
    return contextlib.nullcontext()


def collect(c, outputs: list, first: int) -> None:
    losses = torch.stack(outputs).double().cpu()
    c.run.failed = int((~torch.isfinite(losses)).sum())


def reference(c, model, **fault) -> dict:
    """The reference's losses, first gradients and changes over the check's
    steps, from ``model`` (put in the program's place)."""
    t = c.cfg["train"]
    steps = [(c.rows_on_device(i), c.state["check_draws"][i]) for i in range(CHECK_STEPS)]
    return ref_step.train_steps(model, steps, c.cfg, c.decode, block=c.cfg["reference_block"],
                                total_steps=t["steps_per_epoch"] * t["epochs"], **fault)


def check(c) -> dict:
    """The numbers compared, each beside its limit."""
    c.run.reference_out = reference(c, c.reference_model())
    return compare.train_numbers(c.run.program_out, c.run.reference_out,
                                 c.cfg["limits"][KIND])


def faults(c) -> dict:
    """The faults planted in the reference in the program's place, by name:
    half of every batch left out (the mean over the rest), one label
    altered."""
    return {"half_batch": {"lost_rows": c.batch // 2}, "wrong_label": {"wrong_label": True}}


def readings(c, got: dict) -> dict:
    """The numbers compared for outputs ``got`` in the program's place."""
    numbers = compare.train_numbers(got, c.run.reference_out, c.cfg["limits"][KIND])
    return {k: v["value"] for k, v in numbers.items()}


def diagnostics(c, got: dict) -> dict:
    """Beside the numbers: each leaf's gap over its own norm and the leaf
    (``check.own_norm_gaps``), and the leaves left out of ``change_gap``."""
    ref = c.run.reference_out
    return {**compare.own_norm_gaps(got, ref),
            "left_out_leaves": compare.left_out(ref["grad_norm"])}
