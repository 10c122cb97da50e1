#!/usr/bin/env python3
"""Time the two ways of skipping a non-finite fp16 step on one NVIDIA GPU:
the host's read of the finite flag (``Trainer.train_step``, which
``Optimizer.step(finite)`` branches on) against a selection on the device
(every update taken, then each parameter, AdamW moment and AdamW count put
back where the flag is False, as the JAX package's ``select_opt_state``
does, with no host sync).

Run from the root of a checkout, on a machine with a card:

    python3 tools/fp16_skip_ab.py

ViT-Ti in the DCT domain with ``ampdtype fp16`` and the loss scaler, batch
256 on the K=16 wire, as ``chip_smoke.py``'s fp16 phase; two Trainers from
one seed, the second with a capturable AdamW (its count on the device).
The device selection is first held to the skip's contract: after a step
made non-finite on purpose, the parameters, moments and AdamW's count are
bit-identical.  Then ``PAIRS`` pairs of turns of ``STEPS`` steps each, the
order alternating within pairs (host, device; device, host; ...).  Per
turn: wall ms a step (synchronized at the turn's end), the host's ms a step
until the last step was enqueued, and the process's CPU ms a step; per
variant the device time of one step (``chip_smoke.device_ms``).  Prints
the medians and ranges, then one JSON object with every number.  Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

PAIRS = 8  # pairs of turns, each pair one turn of either variant
STEPS = 25  # steps a turn


def make_trainer(steps: int, capturable: bool):
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=cs.BATCH, seed=cs.SEED,
                          epochs=1, warmup_steps=1, lr=3e-3, amp=True, ampdtype="fp16")
    trainer = Trainer(cfg, device="cuda")
    trainer.create_state(steps_per_epoch=steps)
    if capturable:
        old = trainer.optimizer.opt
        groups = [{"params": g["params"], "weight_decay": g["weight_decay"]}
                  for g in old.param_groups]
        d = old.defaults
        trainer.optimizer.opt = torch.optim.AdamW(groups, lr=d["lr"], betas=d["betas"],
                                                  eps=d["eps"], foreach=True, capturable=True)
    return trainer


def select_step(opt, finite) -> None:
    """One ``Optimizer`` step whose effect is kept only where ``finite``."""
    import torch

    from rgbnomore_tpu_torch.train.optim import clip_by_global_norm

    adamw = opt.opt
    state = [t for p in opt.params for t in adamw.state[p].values()]
    kept = opt.params + state
    before = torch._foreach_mul(kept, 1.0)
    clip_by_global_norm([p.grad for p in opt.params], opt.clip_norm)
    lr = opt.schedule(opt.count)
    for group in adamw.param_groups:
        group["lr"] = lr
    adamw.step()
    opt.count += 1
    with torch.no_grad():
        for now, was in zip(kept, before):
            torch.where(finite, now, was, out=now)


def device_train_step(trainer, packed):
    from rgbnomore_tpu_torch.train.scaler import all_finite, update_loss_scale

    loss = trainer.compute_grads(packed, trainer.draw(packed.shape[0]))
    finite = all_finite(p.grad for p in trainer.model.parameters())
    select_step(trainer.optimizer, finite)
    trainer.loss_scale = update_loss_scale(trainer.loss_scale, finite)
    return loss


def check_skip(trainer, packed) -> None:
    """A step made non-finite on purpose (an infinite weight) leaves the
    device variant's parameters, moments and AdamW count bit-identical."""
    import torch

    weight = trainer.model.patchembed.projection.weight
    saved = weight.detach()[0, 0].clone()
    with torch.no_grad():
        weight[0, 0] = float("inf")
    adamw = trainer.optimizer.opt
    snap = [t.detach().clone() for p in trainer.optimizer.params
            for t in (p, *adamw.state[p].values())]
    device_train_step(trainer, packed)
    torch.cuda.synchronize()
    now = [t for p in trainer.optimizer.params for t in (p, *adamw.state[p].values())]
    cs.check(all(torch.equal(a, b) for a, b in zip(now, snap)),
             "the device selection changed state on a non-finite step")
    with torch.no_grad():
        weight[0, 0] = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp16_skip_ab: no CUDA device", file=sys.stderr)
        return 1
    print(cs.phase_card(), flush=True)
    total = 2 * PAIRS * STEPS + 40
    trainers = {"host": make_trainer(total, False), "device": make_trainer(total, True)}
    steps = {"host": lambda tr, pk: tr.train_step(pk), "device": device_train_step}
    rng = np.random.default_rng(cs.SEED + 8)
    y, c = cs.synthetic_planes(rng, cs.BATCH, cs.GRID)
    rows = cs.write_rows(y, c, (np.arange(cs.BATCH) % 1000).astype(np.int32), cs.K_TRAIN)
    packed = {k: tr.put_batch({"packed": rows})["packed"] for k, tr in trainers.items()}
    for k, tr in trainers.items():
        for _ in range(5):  # warm-up; AdamW makes its state on the first step
            steps[k](tr, packed[k])
    torch.cuda.synchronize()
    check_skip(trainers["device"], packed["device"])
    device = {k: cs.device_ms(lambda k=k: steps[k](trainers[k], packed[k]))
              for k in trainers}
    turns = {k: {"wall_ms": [], "enqueue_ms": [], "cpu_ms": []} for k in trainers}
    load = [os.getloadavg()]
    for pair in range(PAIRS):
        for k in (("host", "device") if pair % 2 == 0 else ("device", "host")):
            tr, pk = trainers[k], packed[k]
            torch.cuda.synchronize()
            c0, t0 = time.process_time(), time.perf_counter()
            for _ in range(STEPS):
                steps[k](tr, pk)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2, c2 = time.perf_counter(), time.process_time()
            turns[k]["wall_ms"].append((t2 - t0) / STEPS * 1e3)
            turns[k]["enqueue_ms"].append((t1 - t0) / STEPS * 1e3)
            turns[k]["cpu_ms"].append((c2 - c0) / STEPS * 1e3)
    load.append(os.getloadavg())
    for k in trainers:
        loss = float(steps[k](trainers[k], packed[k]))
        cs.check(np.isfinite(loss), f"{k}: loss {loss} after the turns")
    summary = {}
    for k, t in turns.items():
        summary[k] = {m: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                      for m, v in t.items()}
        summary[k]["device_ms"] = device[k]
        print(f"{k}: wall {summary[k]['wall_ms']['median']:.3f} ms a step "
              f"({summary[k]['wall_ms']['min']:.3f}-{summary[k]['wall_ms']['max']:.3f}), "
              f"enqueued in {summary[k]['enqueue_ms']['median']:.3f} "
              f"({summary[k]['enqueue_ms']['min']:.3f}-{summary[k]['enqueue_ms']['max']:.3f}), "
              f"CPU {summary[k]['cpu_ms']['median']:.3f} "
              f"({summary[k]['cpu_ms']['min']:.3f}-{summary[k]['cpu_ms']['max']:.3f}); "
              f"device {cs.ms_text(device[k])} a step", flush=True)
    diff = [h - d for h, d in zip(turns["host"]["wall_ms"], turns["device"]["wall_ms"])]
    print(f"host - device, pair by pair: {[round(x, 3) for x in diff]} ms a step; median "
          f"{statistics.median(diff):.3f}; load average before / after {load}; "
          f"{len(os.sched_getaffinity(0))} cores", flush=True)
    print(json.dumps({"pairs": PAIRS, "steps": STEPS, "turns": turns,
                      "summary": summary, "host_minus_device_ms": diff, "load": load}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
