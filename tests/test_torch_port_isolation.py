"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run without a GPU unless the CPU is asked for."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.eval import evaluate_model
from rgbnomore_tpu_torch.train.config import build_model, example_inputs, generate_config
from rgbnomore_tpu_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
preloaded = set(sys.modules)  # whatever the interpreter's own start-up loaded
import rgbnomore_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rgbnomore_tpu_torch.__path__,
                                                "rgbnomore_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.synthetic_planes, chip_smoke.pack_mask16, chip_smoke.write_rows
banned = sorted(m for m in set(sys.modules) - preloaded
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "rgbnomore_tpu"))
print(len(names), banned)
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, banned = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_modules) >= 20, res.stdout
    assert banned == "[]", f"the port pulled in {banned}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    cfg = generate_config("vitti", "dct", modelver=1)
    cfg.model.depth = 1
    return cfg


@pytest.mark.parametrize("entry", [
    lambda: resolve_device(),
    lambda: resolve_device("cuda"),
    lambda: build_model(_cfg()),
    lambda: example_inputs(_cfg()),
    lambda: Trainer(_cfg()),
    lambda: Trainer(_cfg()).create_state(1),
    lambda: Trainer(_cfg()).train_step(torch.zeros((2, 8), dtype=torch.uint8)),
    lambda: Trainer(_cfg()).train_pipe,
    lambda: evaluate_model(_cfg(), "unused.csv", "unused.csv"),
], ids=["resolve_device", "resolve_cuda", "build_model", "example_inputs", "Trainer",
        "create_state", "train_step", "train_pipe", "evaluate_model"])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_cpu_runs_when_asked(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    model = build_model(_cfg(), device="cpu")
    with torch.inference_mode():
        logits = model(*example_inputs(_cfg(), batch=1, device="cpu"))
    assert logits.shape == (1, 1000) and next(model.parameters()).device.type == "cpu"


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_trains_when_asked(no_cuda, rng):
    """One full-width train step of a one-block ViT-Ti on the CPU: the
    pipeline takes its plain path on the CPU buffer, the loss is finite and
    the parameters move."""
    import chip_smoke
    from torch_port_support import settle_inspect_module_walk

    settle_inspect_module_walk()
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    trainer.create_state(steps_per_epoch=10)
    y, c = chip_smoke.synthetic_planes(rng, 2, cfg.model.dct_blocks)
    rows = chip_smoke.write_rows(y, c, np.array([3, 999], np.int32), 16)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    loss = trainer.train_step(trainer.put_batch({"packed": rows})["packed"])
    assert loss.device.type == "cpu" and np.isfinite(float(loss)) and trainer.step == 1
    assert all(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
