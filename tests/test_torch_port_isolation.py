"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run without a GPU unless the CPU is asked for."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbnomore_tpu_torch import cli, parallel
from rgbnomore_tpu_torch.benchmark import benchmark_model, benchmark_model_synthetic
from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.eval import evaluate_model
from rgbnomore_tpu_torch.train.config import build_model, example_inputs, generate_config
from rgbnomore_tpu_torch.train.loop import Trainer, train_and_eval

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
import torch_port_support
torch_port_support.synthetic_planes, torch_port_support.pack_mask16, torch_port_support.write_rows
banned = sorted(m for m in set(sys.modules) - preloaded
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "rgbnomore_tpu"))
print(len(names), banned)
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, banned = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_modules) >= 20, res.stdout
    assert banned == "[]", f"the port pulled in {banned}"


_RUN_TOOL = """
import runpy, sys
sys.argv = {argv!r}
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as exc:
    print(exc.code, sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "flax", "rgbnomore_tpu")))
"""


def _run_tool_without_card(*argv: str) -> None:
    """Run a card tool where there is no card: it must import nothing of
    JAX and exit non-zero, with no result."""
    res = subprocess.run([sys.executable, "-c", _RUN_TOOL.format(argv=list(argv))], cwd=REPO,
                         text=True, capture_output=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.stdout.strip().splitlines()[-1] == "1 []", (res.stdout, res.stderr)
    assert "no CUDA device" in res.stderr


def test_window_kernel_ab_needs_a_card_and_imports_no_jax():
    """The kernel A/B script, on the window kernels."""
    _run_tool_without_card("tools/kernel_ab.py", "--family", "window", "--other", "unused")


def test_attention_h16_ab_needs_a_card_and_imports_no_jax():
    """The kernel A/B script, on the half-precision attention kernels."""
    _run_tool_without_card("tools/kernel_ab.py", "--family", "attention_h16", "--other",
                           "unused")


def test_attention_h16_probe_needs_a_card_and_imports_no_jax():
    """The kernel A/B script's probes exit non-zero without a card, before
    building, and pull in no JAX."""
    _run_tool_without_card("tools/kernel_ab.py", "--family", "attention_h16", "--probe",
                           "bwd_no_dq")


def _kernel_ab():
    import importlib.util

    spec = importlib.util.spec_from_file_location("kernel_ab", REPO / "tools" / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("probe", sorted(_kernel_ab().H16_PROBES))
def test_attention_h16_probe_applies_to_the_sources(probe, tmp_path):
    """Each probe's replaced lines are in this checkout's kernel source as
    many times as the probe says, so an edit of those lines shows here and
    not first on the card."""
    ab = _kernel_ab()
    out = ab.probe_dir(tmp_path, probe)
    source, subs = ab.H16_PROBES[probe]
    text = (out / source).read_text()
    for old, new, count in subs:
        assert text.count(new) >= count and (old not in new) == (old not in text)


def test_fp16_skip_ab_needs_a_card_and_imports_no_jax():
    """The fp16 skip A/B script (host read against device selection)."""
    _run_tool_without_card("tools/fp16_skip_ab.py")


@pytest.mark.parametrize("module", ["rgbnomore_tpu_torch.train.scaler",
                                    "rgbnomore_tpu_torch.ops.attention",
                                    "rgbnomore_tpu_torch.models.layers"])
def test_amp_modules_import_alone(module):
    """The mixed-precision modules (the loss scaler, the attention wrappers
    with their half-precision kernels, the flax-rule layers) import on their
    own with nothing of JAX."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'rgbnomore_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", ["rgbnomore_tpu_torch.cli",
                                    "rgbnomore_tpu_torch.eval",
                                    "rgbnomore_tpu_torch.parallel",
                                    "rgbnomore_tpu_torch.parallel.dist",
                                    "rgbnomore_tpu_torch.utils.metrics",
                                    "rgbnomore_tpu_torch.train.checkpoint",
                                    "rgbnomore_tpu_torch.train.loop",
                                    "rgbnomore_tpu_torch.benchmark",
                                    "rgbnomore_tpu_torch.bench",
                                    "rgbnomore_tpu_torch.utils.timing",
                                    "rgbnomore_tpu_torch.augment.crops",
                                    "rgbnomore_tpu_torch.augment.rgb",
                                    "rgbnomore_tpu_torch.augment.convert",
                                    "rgbnomore_tpu_torch.ops.geometry",
                                    "rgbnomore_tpu_torch.ops.fastdct",
                                    "rgbnomore_tpu_torch.ops.pixel_decode"])
def test_trainer_modules_import_alone(module):
    """The trainer's modules (the CLIs, data parallelism, the loss window,
    checkpoints, the epoch loop) import on their own with nothing of JAX,
    flax, Orbax or the JAX package."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax', 'rgbnomore_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


# what a kernel source may include: the CUDA runtime and its 16-bit types,
# cuda.h's types (TMA's tensor maps), the C and C++ standard libraries
# (dlfcn: libcuda's tensor-map encoder, looked up at run time), and the
# port's own headers beside it
_ALLOWED_INCLUDES = {"<cuda_runtime.h>", "<cuda_bf16.h>", "<cuda_fp16.h>", "<cuda.h>",
                     "<algorithm>", "<climits>", "<dlfcn.h>", "<math.h>", "<stdint.h>",
                     "<type_traits>"}


def test_kernel_sources_stand_alone():
    """Every CUDA source under ``csrc/`` is built (``cuda_build.KERNELS``)
    and every built one is there; each includes only the CUDA toolkit's
    headers, the standard library and the port's headers, no PyTorch header
    (a build in seconds, bound through ctypes)."""
    from rgbnomore_tpu_torch.ops import cuda_build

    sources = {p.name for p in cuda_build.CSRC.glob("*.cu")}
    assert sources == set(cuda_build.KERNELS.values())
    assert {"attention_h16_fwd.cu", "attention_h16_bwd.cu"} <= sources
    headers = {p.name for p in cuda_build.CSRC.glob("*.cuh")}
    for path in [*cuda_build.CSRC.glob("*.cu"), *cuda_build.CSRC.glob("*.cuh")]:
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                inc = line.split(None, 1)[1].strip()
                assert inc in _ALLOWED_INCLUDES or inc.strip('"') in headers, (path.name, inc)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    cfg = generate_config("vitti", "dct", modelver=1)
    cfg.model.depth = 1
    return cfg


def _swin_cfg():
    """SwinV2-T as the preset gives it, in float32."""
    cfg = generate_config("swinv2", "dct")
    cfg.train.amp = False
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
    lambda: build_model(_swin_cfg()),
    lambda: example_inputs(_swin_cfg()),
    lambda: Trainer(_swin_cfg()),
    lambda: evaluate_model(_swin_cfg(), "unused.csv", "unused.csv"),
    lambda: train_and_eval(_cfg(), "unused.csv", "unused.csv"),
    lambda: cli.main(["--train", "--eval", "--model_arch", "vitti", "--embed_type", "1"]),
    lambda: parallel.init_distributed("localhost:1", num_processes=1, process_id=0),
    lambda: Trainer(_cfg(), transfer="packed"),
    lambda: benchmark_model_synthetic(_cfg(), 1, "fwd"),
    lambda: benchmark_model(_cfg(), 1, "unused.csv", "unused.csv"),
    lambda: Trainer(generate_config("vits", "rgb")),
    lambda: cli.main(["--train", "--eval", "--domain", "rgb"]),
], ids=["resolve_device", "resolve_cuda", "build_model", "example_inputs", "Trainer",
        "create_state", "train_step", "train_pipe", "evaluate_model", "swin_build_model",
        "swin_example_inputs", "swin_Trainer", "swin_evaluate_model", "train_and_eval",
        "cli", "init_distributed", "packed_Trainer", "benchmark_model_synthetic",
        "benchmark_model", "rgb_Trainer", "rgb_cli"])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_cpu_runs_when_asked(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    model = build_model(_cfg(), device="cpu")
    with torch.inference_mode():
        logits = model(*example_inputs(_cfg(), batch=1, device="cpu"))
    assert logits.shape == (1, 1000) and next(model.parameters()).device.type == "cpu"


def test_cpu_runs_swin_when_asked(no_cuda):
    """Full-width SwinV2-T builds and runs on the CPU when asked: a forward
    of one image of 32x32 blocks, and a Trainer whose pipelines and model
    live on the CPU."""
    cfg = _swin_cfg()
    model = build_model(cfg, device="cpu")
    with torch.inference_mode():
        logits = model.eval()(*example_inputs(cfg, batch=1, device="cpu"))
    assert logits.shape == (1, 1000) and torch.isfinite(logits).all()
    assert sum(p.numel() for p in model.parameters()) > 27e6  # SwinV2-T: 28.3M
    trainer = Trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu" and trainer.train_pipe.target == 32
    assert len(trainer.draw(2).drop_keep) == 12


def test_swin_refuses_amp(no_cuda):
    """The SwinV2 preset turns bf16 AMP on, which the port builds on the CPU
    when asked; an AMP dtype the JAX package does not know is refused."""
    cfg = generate_config("swinv2", "dct")
    assert build_model(cfg, device="cpu").dtype == torch.bfloat16
    cfg.model.amp_dtype = "fp8"
    with pytest.raises(ValueError, match="unsupported ampdtype"):
        build_model(cfg, device="cpu")


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_trains_when_asked(no_cuda, rng):
    """One full-width train step of a one-block ViT-Ti on the CPU: the
    pipeline takes its plain path on the CPU buffer, the loss is finite and
    the parameters move."""
    from torch_port_support import settle_inspect_module_walk, synthetic_planes, write_rows

    settle_inspect_module_walk()
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    trainer.create_state(steps_per_epoch=10)
    y, c = synthetic_planes(rng, 2, cfg.model.dct_blocks)
    rows = write_rows(y, c, np.array([3, 999], np.int32), 16)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    loss = trainer.train_step(trainer.put_batch({"packed": rows})["packed"])
    assert loss.device.type == "cpu" and np.isfinite(float(loss)) and trainer.step == 1
    assert all(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
