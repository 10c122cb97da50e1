"""The numbers that decide ``correct``, each against its limit.

Training (three steps, the program's against the reference's):

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient (as AdamW received it, after
  the clip), over the reference's norm of that leaf or of the median leaf,
  whichever is larger.
- ``change_gap``: the same for each leaf's change over the three steps,
  leaving out the leaves whose reference gradient norm is under a
  thousandth of the median leaf's (moved by round-off alone under Adam).

Eval (every batch of the window against the reference's sums of its rows):

- ``loss_gap``: the largest gap of a batch's loss sum, over its count.
- ``count_gap``: the largest gap of a batch's weighted count (exact).
- ``top1_gap``: the largest gap of a batch's top-1 tally beyond the rows
  whose top-1 round-off may move (the reference's ``ambiguous``; exact).

The worst leaf is taken against the larger of its own and the median leaf's
reference norm, since some gradients are all but zero; ``own_norm_gaps``
reports each leaf against its own norm beside it, for the calibration.
"""

from __future__ import annotations

import statistics

__all__ = ["eval_numbers", "left_out", "own_norm_gaps", "passed", "train_numbers"]

ZERO_GRAD = 1e-3  # of the median leaf's gradient norm


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    median = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in leaves)


def _entry(value: float, limits: dict, name: str) -> dict:
    return {"value": value, "limit": limits[name]}


def left_out(grad_norm: dict) -> list[str]:
    """The leaves whose reference gradient norm is under ``ZERO_GRAD`` of the
    median leaf's: moved by round-off alone, left out of ``change_gap``."""
    median = statistics.median(grad_norm.values())
    return sorted(n for n, v in grad_norm.items() if v < ZERO_GRAD * median)


def train_numbers(prog: dict, ref: dict, limits: dict) -> dict:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_ref = ref["grad_norm"]
    moving = sorted(set(g_ref) - set(left_out(g_ref)))
    return {
        "loss_gap": _entry(loss, limits, "loss_gap"),
        "grad_gap": _entry(_leaf_gap(prog["grad_norm"], g_ref, g_ref), limits, "grad_gap"),
        "change_gap": _entry(_leaf_gap(prog["change_norm"], ref["change_norm"], moving),
                             limits, "change_gap"),
    }


def own_norm_gaps(prog: dict, ref: dict) -> dict:
    """Beside ``grad_gap`` and ``change_gap``: the largest gap of a leaf's
    norm over that leaf's own reference norm, and the leaf."""
    g_ref = ref["grad_norm"]
    moving = set(g_ref) - set(left_out(g_ref))
    out = {}
    for key, leaves in (("grad", g_ref), ("change", moving)):
        p, r = prog[f"{key}_norm"], ref[f"{key}_norm"]
        gaps = {n: abs(p[n] - r[n]) / r[n] for n in leaves if r[n] > 0}
        worst = max(gaps, key=gaps.get)
        out[f"{key}_gap_own"], out[f"{key}_gap_own_leaf"] = gaps[worst], worst
    return out


def eval_numbers(prog: dict, ref_sums: list, limits: dict) -> dict:
    loss = count = top1 = 0.0
    for i, (correct, loss_sum, cnt) in enumerate(prog["sums"]):
        want = ref_sums[(prog["first"] + i) % prog["pool"]]
        loss = max(loss, abs(loss_sum - want["loss_sum"]) / max(want["count"], 1.0))
        count = max(count, abs(cnt - want["count"]))
        top1 = max(top1, abs(correct - want["correct"]) - want["ambiguous"])
    return {"loss_gap": _entry(loss, limits, "loss_gap"),
            "count_gap": _entry(count, limits, "count_gap"),
            "top1_gap": _entry(top1, limits, "top1_gap")}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
