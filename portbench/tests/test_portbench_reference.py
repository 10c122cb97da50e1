"""The plain reference against the port's CPU path, and whole runs of the
tiny cells on the CPU: sound, broken underneath (each fault a cell can
have), and with the control in the program's place."""

import time

import numpy as np
import pytest
import torch

import check
import inputs
from calibrate import readings
from faults import FAULTS
from cell import run_cell
from manifest import Manifest
from reference import augment
from reference import models as ref_models
from reference import step as ref_step


def _draws(batch, grid, ops, num_ops=2, rates=None, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return inputs.make_draws(gen, np.random.default_rng(seed), batch, grid, ops, num_ops,
                             0.2, rates)


WIRE = Manifest.wire({"transfer": "cropped", "format": "mask16"})
SPECTRUM = {"ac_amplitude": 300.0, "ac_falloff": 2.0, "ac_nonzero": 0.8, "dc_half_range": 1000.0}


def _rows(seed, batch, grid, k):
    return inputs.make_rows(seed, 1, batch, grid, k, 1000, "cpu", SPECTRUM, WIRE.encode)[0]


AUG = ["AutoContrast", "Posterize", "Color", "Contrast", "Brightness", "Sharpness", "Cutout",
       "TranslateX", "TranslateY", "Rotate90", "AutoSaturation", "Grayscale", "MidfreqAug",
       "ChromaDrop", "SolarizeAdd"]


@pytest.mark.parametrize("grid", [28, 32])
def test_train_stage_matches_the_ports_plain_wire_reader(grid):
    from rgbnomore_tpu_torch.ops.augpipe import wire_flip_aug_range_plain

    rows = torch.from_numpy(_rows(7, 64, grid, 16))
    d = _draws(64, grid, AUG, num_ops=3)
    want = wire_flip_aug_range_plain(rows, d["flip"], d["policy"], target=grid, k=16,
                                     fmt="mask16", ops_list=AUG, num_ops=3, magnitude=3)
    y, c, _, _ = WIRE.decode(rows, grid, 16)
    got = augment.train_stage(y, c, d["flip"], d["policy"], AUG, 3)
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=0)


def test_eval_stage_is_the_ports_bit_for_bit():
    from rgbnomore_tpu_torch.ops.augpipe import wire_to_range_plain

    rows = torch.from_numpy(_rows(8, 8, 28, 48))
    want = wire_to_range_plain(rows, target=28, k=48, fmt="mask16")
    got = augment.eval_stage(*WIRE.decode(rows, 28, 48)[:2])
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("config", ["tiny-vit", "tiny-swin"])
def test_reference_model_matches_the_ports_float32_model(tiny_manifest, config):
    from rgbnomore_tpu_torch.train.config import build_model

    import program

    cfg = tiny_manifest.config(config)
    pc = program._port_config(cfg)
    pc.train.amp = False
    port = build_model(pc, device="cpu")
    ref = ref_models.build(cfg["model"])
    weights = inputs.make_weights(4, ref_models.build(cfg["model"], "meta"), "cpu")
    with torch.no_grad():
        for model in (port, ref):
            for n, p in model.named_parameters():
                p.copy_(weights[n])
    g = cfg["model"]["dct_blocks"]
    y, c = torch.rand(3, 1, g, g, 8, 8) * 2 - 1, torch.rand(3, 2, g // 2, g // 2, 8, 8) * 2 - 1
    port.eval(), ref.eval()
    with torch.no_grad():
        torch.testing.assert_close(ref(y, c), port(y, c), atol=2e-5, rtol=1e-5)


def test_adamw_and_schedule_follow_the_ports_optimizer():
    from rgbnomore_tpu_torch.train.optim import Optimizer

    torch.manual_seed(0)
    lin = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.LayerNorm(4))
    twin = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.LayerNorm(4))
    twin.load_state_dict(lin.state_dict())
    port = Optimizer(lin, 3e-3, 3e-4, 3, 20)
    named = list(twin.named_parameters())
    ref = ref_step.AdamW(named, ref_step.decayed_names(twin), 3e-4 / 3e-3)
    for step in range(5):
        x = torch.randn(6, 5)
        for model in (lin, twin):
            model.zero_grad()
            (model(x) ** 2).sum().backward()
        port.step()
        ref_step.clip_([p.grad for _, p in named], 1.0)
        ref.step(ref_step.lr_at(step, 3e-3, 3, 20))
        assert ref_step.lr_at(step, 3e-3, 3, 20) == port.schedule(step)
    for a, b in zip(lin.parameters(), twin.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def _run(manifest, workload, tamper=None, seed=2**31 + 99):
    return run_cell(workload, seed, 0.01, False, t_start=time.perf_counter(), device="cpu",
                    manifest=manifest, tamper=tamper)


@pytest.mark.parametrize("workload", ["vits16-train", "swinv2t-train", "vits16-eval"])
def test_a_sound_run_is_correct(tiny_manifest, workload):
    run = _run(tiny_manifest, workload)
    assert run.correct, run.checks
    result = run.result()
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in tiny_manifest.end_to_end(workload)}


@pytest.mark.parametrize("workload, fault", [
    ("vits16-train", "frozen"), ("vits16-train", "half_batch"), ("vits16-train", "wrong_label"),
    ("swinv2t-train", "frozen"), ("swinv2t-train", "half_batch"),
    ("swinv2t-train", "wrong_label"), ("vits16-eval", "half_batch"),
    ("vits16-eval", "wrong_label"), ("vits16-eval", "miscount"),
])
def test_a_broken_step_is_not_correct(tiny_manifest, workload, fault):
    run = _run(tiny_manifest, workload, tamper=FAULTS[fault])
    assert not run.correct, run.checks


@pytest.mark.parametrize("workload", ["vits16-train", "swinv2t-train", "vits16-eval"])
def test_the_control_is_not_correct(tiny_manifest, workload):
    seed = 2**31 + 5
    run = _run(tiny_manifest, workload, seed=seed)
    control = readings(run, seed, control=True, faults=False)[1]
    limits = run.cfg["limits"][run.kind]
    assert not check.passed({k: {"value": control[k], "limit": v} for k, v in limits.items()})


@pytest.mark.parametrize("fault, correct", [(None, True), ("no_exchange", False)])
def test_four_ranks_hold_to_one_process(tiny_manifest, fault, correct):
    from ranks import run_ranks

    result, found, error = run_ranks(4, workload="vits16-train-dp4", seed=2**31 + 11,
                                     seconds=0.05, trace=False, t_start=time.perf_counter(),
                                     device="cpu", manifest=tiny_manifest, fault=fault)
    assert error is None and found == []
    assert result["correct"] is correct, result["checks"]
    assert result["device"]["count"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vits16-eval", "swinv2t-train"])
def test_a_cell_on_the_card_is_correct(card, workload):
    from manifest import Manifest

    run = run_cell(workload, 2**31 + 21, 1.0, False, t_start=time.perf_counter(),
                   manifest=Manifest())
    assert run.correct, run.checks
    assert run.result()["device"]["platform"] == "gpu"
