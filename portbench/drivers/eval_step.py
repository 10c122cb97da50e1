"""Driver of the port's eval batch: ``Trainer.upload`` + ``Trainer.eval_step``
under ``inference_mode``.

Set-up runs two batches to warm up.  The window's outputs are each batch's
sums (correct, loss_sum, count), read once it has closed; the reference
(``reference/step.py:eval_sums``) recomputes the sums of every pool batch,
and every batch of the window is compared with its pool batch's.
"""

from __future__ import annotations

import torch

import check as compare
from reference import step as ref_step

KIND = "eval"
WIRE_K = "eval_k"
SHARDS = False  # one process
TRAFFIC_KEYS = {"batch"}
WARM_UP_BATCHES = 2


def batch(cfg: dict, traffic: dict) -> int:
    """The traffic's batch."""
    return traffic["batch"]


def prepare(c) -> int:
    with torch.inference_mode():
        for i in range(WARM_UP_BATCHES):
            c.trainer.eval_step(c.upload(i))
    return 0


def step(c, i: int) -> dict:
    return c.trainer.eval_step(c.upload(i))


def window():
    return torch.inference_mode()


def collect(c, outputs: list, first: int) -> None:
    sums = torch.stack([torch.stack([s["correct"], s["loss_sum"], s["count"]])
                        for s in outputs]).double().cpu()
    c.run.failed = int((~torch.isfinite(sums)).any(dim=1).sum())
    c.run.program_out = {"sums": sums.tolist(), "first": first, "pool": len(c.pool)}


def reference(c, model, **fault) -> list:
    """The reference's sums of every pool batch from ``model``."""
    return [ref_step.eval_sums(model, c.rows_on_device(i), c.cfg, c.decode,
                               block=c.cfg["reference_block"], **fault)
            for i in range(len(c.pool))]


def check(c) -> dict:
    """The numbers compared, each beside its limit."""
    c.run.reference_out = {"sums": reference(c, c.reference_model())}
    return compare.eval_numbers(c.run.program_out, c.run.reference_out["sums"],
                                c.cfg["limits"][KIND])


def faults(c) -> dict:
    """The faults planted in the reference in the program's place, by name:
    half of every batch left out, one label altered, the top-1 tally off by
    one."""
    return {"half_batch": {"lost_rows": c.batch // 2}, "wrong_label": {"wrong_label": True},
            "miscount": {"miscount": True}}


def readings(c, got: list) -> dict:
    """The numbers compared for sums ``got`` (one per pool batch) in the
    program's place."""
    prog = {"sums": [[s["correct"], s["loss_sum"], s["count"]] for s in got], "first": 0,
            "pool": len(got)}
    numbers = compare.eval_numbers(prog, c.run.reference_out["sums"], c.cfg["limits"][KIND])
    return {k: v["value"] for k, v in numbers.items()}


def diagnostics(c, got) -> dict:
    return {}
