"""The port's train step against the JAX package's, on the CPU.

- ``mixup_batch`` with a given lambda, and ``softmax_cross_entropy``.
- The warmup-cosine schedule at steps 0, warmup-1, warmup and total.
- The weight-decay mask against ``kernel_mask`` through ``convert``'s key
  mapping.
- Global-norm clipping against optax's.
- A 3-step lockstep of ``Trainer.train_step`` against the JAX ``Trainer``
  (``transfer="cropped"``, ``fused_aug=False``) at depth 2, emb 48, 2 heads,
  an 8x8 grid and batch 4, from the same parameters and rows, with the JAX
  step's draws (flip, policy, mixup lambda) re-derived from its keys and
  handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from torch_port_support import jax_step_draws, settle_inspect_module_walk
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.train.loop import Trainer as JaxTrainer
from rgbnomore_tpu.train.optim import kernel_mask, warmup_cosine_schedule as jax_schedule
from rgbnomore_tpu.train.steps import mixup_batch as jax_mixup
from rgbnomore_tpu.train.steps import softmax_cross_entropy as jax_ce
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer
from rgbnomore_tpu_torch.train.optim import (
    clip_by_global_norm,
    decay_parameter_names,
    warmup_cosine_schedule,
)
from rgbnomore_tpu_torch.train.steps import (
    draw_mixup_lambda,
    mixup_batch,
    softmax_cross_entropy,
)


def test_mixup_matches_jax(rng):
    """With JAX's lambda handed over, the mixed inputs and targets agree."""
    x = rng.standard_normal((5, 3, 4)).astype(np.float32)
    z = rng.standard_normal((5, 2)).astype(np.float32)
    labels = np.array([0, 3, 1, 3, 2], np.int32)
    key = jax.random.PRNGKey(4)
    (jx, jz), jt = jax_mixup(key, (jnp.asarray(x), jnp.asarray(z)), jnp.asarray(labels), 6, 0.2)
    u = jax.random.beta(key, 0.2, 0.2)
    lam = float(jnp.maximum(u, 1.0 - u))
    (gx, gz), gt = mixup_batch((torch.from_numpy(x), torch.from_numpy(z)),
                               torch.from_numpy(labels), 6, lam)
    for got, want in ((gx, jx), (gz, jz), (gt, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=1e-6)


def test_mixup_lambda_is_sorted_and_seeded():
    lams = [draw_mixup_lambda(np.random.default_rng(s), 0.2) for s in range(200)]
    assert all(0.5 <= lam <= 1.0 for lam in lams)
    assert draw_mixup_lambda(np.random.default_rng(3), 0.2) == lams[3]


def test_cross_entropy_matches_jax(rng):
    logits = (rng.standard_normal((6, 10)) * 4).astype(np.float32)
    targets = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 20), (5, 5)])
def test_schedule_matches_jax(warmup, total):
    want, got = jax_schedule(3e-3, warmup, total), warmup_cosine_schedule(3e-3, warmup, total)
    for step in sorted({0, max(warmup - 1, 0), warmup, total}):
        assert got(step) == float(want(step)), step


def _tiny_cfg(gen, classes=10):
    cfg = gen("vitti", "dct", modelver=1, batchsize=4, epochs=1, warmup_steps=2, seed=5)
    cfg.model.depth, cfg.model.embed_size, cfg.model.heads = 2, 48, 2
    cfg.model.head_size, cfg.model.classes, cfg.model.dct_blocks = 24, classes, 8
    cfg.model.input_size = 64
    return cfg


@pytest.fixture(scope="module")
def jax_trainer():
    cfg = _tiny_cfg(jax_generate_config)
    trainer = JaxTrainer(cfg, devices=jax.devices()[:1], transfer="cropped", fused_aug=False)
    trainer.create_state(steps_per_epoch=10)
    return trainer


def test_decay_mask_matches_kernel_mask(jax_trainer):
    """Every flax ``kernel`` leaf maps to a parameter that decays; every
    ``scale`` and ``bias`` to one that does not."""
    params = jax.tree.map(np.asarray, jax_trainer.state.params)
    mask = kernel_mask(params)
    flat_mask = {"/".join(str(k.key) for k in path): bool(v)
                 for path, v in jax.tree_util.tree_leaves_with_path(mask)}
    # one parameter per leaf, converted alone so the key mapping is convert's
    want = set()
    for path_str, decays in flat_mask.items():
        tree = node = {}
        *mods, leaf = path_str.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.zeros((2, 2), np.float32)
        (key,) = flax_to_state_dict(tree)
        if decays:
            want.add(key)
    model = Trainer(_tiny_cfg(generate_config), device="cpu").model
    assert decay_parameter_names(model) == want
    assert len(want) == sum(flat_mask.values()) > 0
    assert set(dict(model.named_parameters())) == {
        k for k in flax_to_state_dict(params)}


def test_clip_matches_optax(rng):
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for scale in (0.05, 1.0, 7.0):  # norm below and above the limit
        g = [a * scale for a in grads]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in g], None)
        got = [torch.from_numpy(a.copy()) for a in g]
        norm = clip_by_global_norm(got, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)


# Losses agree to float32 rounding: 1.4e-6 relative over these 3 steps.
# Parameters move by up to 7.5e-3 in them; they agree to 6e-6, because every
# Adam step moves a parameter by about lr * g / (|g| + eps), which is the
# same in both frameworks wherever g is far above rounding.  The key third
# of each qkv bias has a gradient that is zero in exact arithmetic (softmax
# ignores a shift shared by all keys of a row); its rounding noise drives
# Adam's normalized step differently in each framework (3.3e-5 apart after
# 3 steps), so those entries are held to what the steps can move a
# parameter at most, the sum of the learning rates.
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _key_bias_entries(name, cfg):
    if not name.endswith("mha.qkv.bias"):
        return None
    inner = cfg.model.heads * cfg.model.head_size
    return slice(inner, 2 * inner)


def test_train_steps_lockstep_with_jax(jax_trainer):
    jt = jax_trainer
    cfg = _tiny_cfg(generate_config)
    grid, b = cfg.model.dct_blocks, cfg.train.batch_size
    rng = np.random.default_rng(0)
    y, c = chip_smoke.synthetic_planes(rng, b, grid)
    rows = chip_smoke.write_rows(y, c, np.array([1, 7, 3, 7], np.int32), 16)

    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jt.state.params)))
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    step_fn = jt._fused_train_step()
    base_rng = jax.random.PRNGKey(cfg.seed + 1)
    schedule = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup, 10)
    state = jax.tree.map(jnp.copy, jt.state)  # the step donates its state
    for step in range(3):
        draws = jax_step_draws(jt, base_rng, step, b, grid)
        state, metrics = step_fn(state, jt.put_batch({"packed": rows}), base_rng)
        loss = trainer.train_step(torch.from_numpy(rows), draws)
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params))
        lr_sum = sum(schedule(s) for s in range(step + 1))
        for name, p in trainer.model.named_parameters():
            got, ref = p.detach().numpy(), want[name].numpy()
            keys = _key_bias_entries(name, cfg)
            if keys is not None:
                assert np.abs(got[keys] - ref[keys]).max() <= lr_sum, name
                got, ref = np.delete(got, np.r_[keys], axis=0), np.delete(ref, np.r_[keys], axis=0)
            np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=f"{name} step {step}")
    assert trainer.step == 3 and int(state.step) == 3


@pytest.mark.parametrize("flag", [False, True], ids=["off", "on"])
def test_deterministic_flag(flag):
    """``cfg.train.deterministic`` set, building the Trainer turns on
    deterministic algorithms, deterministic cuDNN and the cuBLAS workspace
    setting (``configure_determinism``); unset, it changes none of them.
    The process's global state is restored afterwards."""
    import os

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        torch.use_deterministic_algorithms(False)
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.backends.cudnn.deterministic = False
        cfg = generate_config("vitti", "dct", modelver=1, deterministic=flag)
        cfg.model.depth = 1
        Trainer(cfg, device="cpu")
        assert torch.are_deterministic_algorithms_enabled() == flag
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == (":4096:8" if flag else None)
        assert torch.backends.cudnn.deterministic == flag
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        if saved[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[2]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[3:]


def test_dropout_refusal_states_the_reference():
    """The port refuses dropout until it is ported, and says what the JAX
    ViT drops: never the attention probabilities."""
    cfg = generate_config("vitti", "dct", modelver=1, drop=0.1)
    cfg.model.depth = 1
    with pytest.raises(NotImplementedError, match="never drops attention probabilities"):
        Trainer(cfg, device="cpu").create_state(1)
