#!/usr/bin/env python3
"""Which ``torch.profiler`` set-ups drop the first kernels of a traced block,
on one NVIDIA GPU, in the state ``chip_smoke.py`` leaves the process in.

Run from the root of a checkout, on a machine with a card:

    python3 tools/trace_drop_ab.py --order trace,bare,burst,margin,bare,trace

It runs ``chip_smoke.py``'s phases in order, and in place of the harness
phase's trace check it traces 3 ViT-Ti train steps at batch 256 once for
each name of ``--order``, each after a profiler session of the CUDA activity
alone (``chip_smoke.device_ms``), as the smoke's earlier phases run them:

- ``bare``: a ``torch.profiler.profile`` of the CPU and CUDA activities;
- ``margin``: the same, the card idle 10 ms at each end of the block;
- ``burst``: the same, after 256 tiny kernels launched inside the window;
- ``trace``: ``rgbnomore_tpu_torch.utils.profiling.trace``.

Prints one line per trace: whether it names #1's, #2's and #5w's kernels as
often as their launch counters say, its host launches, and those with no
kernel (by correlation id) with their times into the window.  Then exits,
without the smoke's later checks and its result lines.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def _settle() -> None:
    import torch

    torch.cuda.synchronize()
    time.sleep(0.01)


def _bare(logdir, setup=None, margin=False):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    @contextlib.contextmanager
    def run():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            if setup:
                setup()
            if margin:
                _settle()
            yield prof
            if margin or setup:
                _settle()

    return run()


def _burst() -> None:
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(256):
        x.add_(1)
    _settle()


def variant(name: str, logdir: str):
    from rgbnomore_tpu_torch.utils.profiling import trace

    return {"bare": lambda: _bare(logdir),
            "margin": lambda: _bare(logdir, margin=True),
            "burst": lambda: _bare(logdir, setup=_burst),
            "trace": lambda: trace(logdir)}[name]()


def compare(order: list[str]) -> None:
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cs = chip_smoke
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=cs.BATCH, seed=cs.SEED,
                          epochs=1, warmup_steps=1)
    trainer = Trainer(cfg, device="cuda")
    trainer.create_state(steps_per_epoch=1000)
    packed = trainer.put_batch({"packed": cs.vit_rows(np.random.default_rng(cs.SEED + 23),
                                                      cs.BATCH, cs.K_TRAIN)})["packed"]
    trainer.train_step(packed)
    cs.timed_steps(trainer, packed, cs.HARNESS_STEPS)
    for i, name in enumerate(order):
        logdir = tempfile.mkdtemp()
        cs.device_ms(lambda: trainer.train_step(packed), reps=3)
        with cs.plain_unpacks():
            cs.reset_launches()
            with variant(name, logdir):
                cs.timed_steps(trainer, packed, cs.HARNESS_STEPS)
            launches = cs.all_launches()
        got = cs.read_trace(logdir)
        want = {k: launches[c] for k, c in cs.TRACE_KERNELS.items()}
        dropped = [round(x) for x in got["dropped"]]
        print(f"variant #{i} {name}: {'OK' if got['seen'] == want else 'SHORT'} names "
              f"{got['seen']}; {got['launches']} launches, {len(dropped)} with no kernel, at "
              f"{dropped[:5]}..{dropped[-3:]} us", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", default="trace,bare,burst,margin,bare,trace")
    order = parser.parse_args().order.split(",")
    unknown = set(order) - {"bare", "margin", "burst", "trace"}
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")

    def harness_trace(report, tmp, card):
        compare(order)
        sys.stdout.flush()
        os._exit(0)  # the smoke's later phases are not this tool's

    chip_smoke.harness_trace = harness_trace
    sys.argv = sys.argv[:1]
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
