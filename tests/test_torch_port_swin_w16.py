"""SwinV2 at window 16 on the port's CPU path, against the benchmark's plain
reference (``portbench/reference/models.py:SwinV2``, loaded by its path: it
imports neither the port nor JAX).

The tiny configuration keeps SwinV2-B/w16's window and every branch of it:
depths (2, 2, 2, 2), heads (2, 2, 4, 4), embed 16, window 16, on a 16x16
DCT block grid (32x32 tokens after the patch-4 embedding): stage 1 holds 4
windows of 256 tokens, its odd block shifted by 8 under the -100 mask;
stage 2 clamps to one 256-token window, unshifted; stages 3 and 4 clamp to
64 and 16 tokens.  Weights are seeded (every LayerNorm scale away from 0,
the CPB-MLP and logit scales drawn), in float32.  Logits and every leaf's
gradient of one loss agree to float32's round-off, the two differing only
in the order of sums (the port's einsum and softmax against the
reference's): logits to 1e-5 of the largest (measured 3.9e-7), gradients to
5e-5 of each leaf's largest entry (measured at most 1.2e-5, the embedding's
LayerNorm, at the end of the longest chain of float32 sums), where a wrong
bias, mask or window reads O(1).  The ``swinv2b`` preset is SwinV2-B/w16 of the Swin-Transformer release
(``swinv2_base_patch4_window16_256``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbnomore_tpu_torch.ops import window_attention as wa
from rgbnomore_tpu_torch.train.config import build_model, generate_config

REFERENCE = Path(__file__).resolve().parent.parent / "portbench" / "reference" / "models.py"
LOGIT_TOL = 1e-5  # of the largest entry: float32 round-off in another order of sums
GRAD_TOL = 5e-5  # of a leaf's largest entry: the same, through 8 blocks backward


def _reference_module():
    spec = importlib.util.spec_from_file_location("portbench_reference_models", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_cfg():
    cfg = generate_config("swinv2b", "dct", seed=3)
    cfg.model.depth, cfg.model.heads, cfg.model.embed_size = (2, 2, 2, 2), (2, 2, 4, 4), 16
    cfg.model.dct_blocks, cfg.model.input_size = 16, 128
    cfg.model.classes, cfg.model.drop_path = 10, 0.0
    cfg.train.amp = False
    return cfg


def _model_section(cfg) -> dict:
    m = cfg.model
    return {"arch": m.arch, "domain": m.domain, "patch_size": m.patch_size,
            "embed_size": m.embed_size, "depth": list(m.depth), "heads": list(m.heads),
            "window_size": m.window_size, "mlp_ratio": m.mlp_ratio, "drop_path": m.drop_path,
            "qkv_bias": m.qkv_bias, "ape": m.ape, "patch_norm": m.patch_norm,
            "classes": m.classes, "dct_blocks": m.dct_blocks, "input_size": m.input_size,
            "amp_dtype": m.amp_dtype}


def _seeded_weights(model, seed: int) -> dict:
    """Matrices N(0, 1/fan_in), vectors N(0, 0.1^2), LayerNorm scales
    1 + N(0, 0.1^2), logit scales log 10 + N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if name.endswith("logit_scale"):
            out[name] = np.log(10.0) + 0.1 * z
        elif p.dim() >= 2:
            out[name] = z / np.sqrt(p.shape[-1])
        elif "norm" in name and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def test_preset_is_swinv2b_window16():
    cfg = generate_config("swinv2b", "dct")
    m, t = cfg.model, cfg.train
    assert m.arch == "swinv2"
    assert (m.embed_size, tuple(m.depth), tuple(m.heads)) == (128, (2, 2, 18, 2), (4, 8, 16, 32))
    assert (m.window_size, m.drop_path, m.mlp_ratio, m.patch_size) == (16, 0.5, 4, 4)
    assert (m.qkv_bias, m.ape, m.patch_norm) == (True, False, True)
    assert (m.dct_blocks, m.input_size, t.dataset) == (32, 256, "imagenet_dct_swin")
    assert (t.amp, m.amp_dtype) == (True, "bf16")
    swin_t = generate_config("swinv2", "dct")
    for key in ("lr", "wd", "warmup", "auglist", "num_ops", "augstr", "augmax", "batch_size",
                "mixup_alpha", "epochs"):
        assert getattr(t, key) == getattr(swin_t.train, key), key


def test_cli_trains_swinv2b(tmp_path, monkeypatch):
    """``--model_arch swinv2b`` trains a step through the Trainer and scores
    the test split; cut to the tiny widths above (window 16 kept), the
    state dict is SwinV2's at embed 16."""
    from rgbnomore_tpu_torch import cli
    from rgbnomore_tpu_torch.train import config, loop
    from torch_port_support import settle_inspect_module_walk, write_corpus

    full = config.generate_config

    def tiny(*a, **kw):
        cfg = full(*a, **kw)
        assert cfg.model.window_size == 16 and tuple(cfg.model.depth) == (2, 2, 18, 2)
        cfg.model.depth, cfg.model.heads, cfg.model.embed_size = (2, 2, 2, 2), (2, 2, 4, 4), 16
        cfg.model.dct_blocks, cfg.model.input_size, cfg.model.classes = 16, 128, 4
        return cfg

    monkeypatch.setattr(config, "generate_config", tiny)
    # TensorBoard's first import takes about 15 s here; the writer is not under test
    real_writer = loop.SummaryWriter
    monkeypatch.setattr(loop, "SummaryWriter", lambda logdir: real_writer(None))
    (tmp_path / "corpus").mkdir()
    corpus = write_corpus(tmp_path / "corpus", n=4, size=64)
    settle_inspect_module_walk()
    weights = tmp_path / "w.pt"
    got = cli.main(["--device", "cpu", "--indexpaths", f"{corpus},{corpus}", "--batch", "2",
                    "--num_cpus", "2", "--verbose", "0", "--model_arch", "swinv2b", "--train",
                    "--eval", "--epochs", "1", "--max_steps_per_epoch", "1", "--savepath",
                    str(weights)])
    assert got["test"]["count"] == 4 and np.isfinite(got["history"][0]["train_loss"])
    state = torch.load(weights, weights_only=True)
    assert state["patch_embed.projection.weight"].shape == (16, 24)


def test_window16_blocks_and_token_counts():
    model = build_model(_tiny_cfg(), device="cpu")
    assert [(b.window_size, b.shift_size) for b in model.blocks()] == [
        (16, 0), (16, 8), (16, 0), (16, 0), (8, 0), (8, 0), (4, 0), (4, 0)]


def test_window16_logits_and_gradients_match_reference():
    ref_models = _reference_module()
    cfg = _tiny_cfg()
    section = _model_section(cfg)
    assert ref_models.check_model(section) == "swinv2"
    port = build_model(cfg, device="cpu")
    ref = ref_models.build(section, "cpu")
    weights = _seeded_weights(ref, seed=11)
    assert set(dict(port.named_parameters())) == set(weights)
    with torch.no_grad():
        for model in (port, ref):
            for name, p in model.named_parameters():
                p.copy_(weights[name])
    gen = torch.Generator().manual_seed(5)
    y = torch.rand((2, 1, 16, 16, 8, 8), generator=gen) * 2 - 1
    c = torch.rand((2, 2, 8, 8, 8, 8), generator=gen) * 2 - 1
    target = torch.randn((2, 10), generator=gen)

    seen = []
    real = wa.window_attention

    def spy(q, k, v, bias):
        seen.append(q.shape[2])
        return real(q, k, v, bias)

    from rgbnomore_tpu_torch.models import swinv2

    results = []
    for model in (port, ref):
        model.zero_grad()
        with pytest.MonkeyPatch.context() as mp:
            if model is port:
                for block in port.blocks():
                    mp.setattr(block.attn, "attention", spy)
            logits = model(y, c)
        (logits * target).sum().backward()
        results.append((logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                          if p.grad is not None}))
    assert seen == [256, 256, 256, 256, 64, 64, 16, 16]
    assert swinv2.window_attention is wa.window_attention
    (got, got_grads), (want, want_grads) = results
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max() / want.abs().max()) < LOGIT_TOL
    assert set(got_grads) == set(want_grads) == set(weights)
    for name, w in want_grads.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((got_grads[name] - w).abs().max()) / scale
        assert err < GRAD_TOL, f"{name}: {err:.2e} of the largest entry"
