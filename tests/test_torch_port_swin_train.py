"""The port's SwinV2 train step against the JAX package's, on the CPU.

- A 3-step lockstep of ``Trainer.train_step`` against the JAX ``Trainer``
  (``transfer="cropped"``) at the tiny SwinV2 configuration of
  ``torch_port_support.tiny_swin_cfg`` without drop path, every LayerNorm
  perturbed, from the same parameters and rows, JAX's draws (flip, policy,
  mixup lambda) handed to the port.
- ``Trainer.draw`` gives SwinV2's drop-path keep masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import (
    jax_step_draws,
    jax_swin_trainer,
    port_swin_trainer,
    settle_inspect_module_walk,
    synthetic_planes,
    tiny_swin_cfg,
    write_rows,
)
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer
from rgbnomore_tpu_torch.train.optim import warmup_cosine_schedule

# Losses agree to float32 rounding over these 3 steps; parameters to 1e-5,
# as in the ViT lockstep (tests/test_torch_port_train.py): every Adam step
# moves a parameter by about lr * g / (|g| + eps), the same in both
# frameworks wherever g is far above its rounding noise.  Where it is not,
# rounding noise drives Adam's normalized step differently in each
# framework.  Here the q and k thirds of the later stages' qkv kernels have
# gradients near 1e-9 (their v thirds near 1e-4), and 6, 8 and 22 of the
# 588,806 entries moved more than 1e-5 apart after steps 1, 2 and 3, each
# with a first-step gradient of 1e-9 to 7e-9.  So at most MAX_NOISY of the
# entries may exceed PARAM_ATOL, and they are held to what the steps can
# move a parameter at most, the sum of the learning rates.
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MAX_NOISY = 1e-4


@pytest.fixture(scope="module")
def jax_trainer():
    return jax_swin_trainer()


def test_train_steps_lockstep_with_jax(jax_trainer):
    jt = jax_trainer
    cfg = tiny_swin_cfg(generate_config)
    grid, b = cfg.model.dct_blocks, cfg.train.batch_size
    y, c = synthetic_planes(np.random.default_rng(0), b, grid)
    rows = write_rows(y, c, np.array([1, 7, 3, 7], np.int32), 16)

    trainer = port_swin_trainer(jt, cfg)
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    step_fn = jt._fused_train_step()
    base_rng = jax.random.PRNGKey(cfg.seed + 1)
    schedule = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup, 10)
    # the step donates its state; a copy through numpy compiles nothing
    state = jax.tree.map(lambda x: jnp.asarray(np.array(x)), jt.state)
    params = dict(trainer.model.named_parameters())
    total = sum(p.numel() for p in params.values())
    for step in range(3):
        draws = jax_step_draws(jt, base_rng, step, b, grid)
        state, metrics = step_fn(state, jt.put_batch({"packed": rows}), base_rng)
        loss = trainer.train_step(torch.from_numpy(rows), draws)
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params))
        lr_sum = sum(schedule(s) for s in range(step + 1))
        beyond = 0
        for name, p in params.items():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert diff.max() <= lr_sum, f"{name} step {step}: {diff.max()}"
            beyond += int((diff > PARAM_ATOL).sum())
        assert beyond <= MAX_NOISY * total, f"step {step}: {beyond} entries beyond {PARAM_ATOL}"
    assert trainer.step == 3 and int(state.step) == 3


def test_draw_gives_drop_path_masks():
    """SwinV2's draws hold a (blocks, 2, B) keep mask: always True at the
    first block (rate 0), about 1 - rate elsewhere; the ViT's hold none."""
    cfg = tiny_swin_cfg(generate_config, batch=4000, drop_path=0.5)
    trainer = Trainer(cfg, device="cpu")
    keep = trainer.draw(4000).drop_keep
    assert keep.shape == (6, 2, 4000) and keep.dtype == torch.bool
    assert bool(keep[0].all())
    rates = trainer.model.drop_path_rates
    for i in range(1, 6):
        assert abs(float(keep[i].float().mean()) - (1 - rates[i])) < 0.03, i
    vit = generate_config("vitti", "dct")
    vit.model.depth = 1
    assert Trainer(vit, device="cpu").draw(2).drop_keep is None


def test_train_step_uses_the_drop_path_masks(rng):
    """A train step with drop path: the draws' keep masks decide the loss,
    and handing the same draws over gives the same loss."""
    cfg = tiny_swin_cfg(generate_config, drop_path=0.5)
    y, c = synthetic_planes(rng, 4, cfg.model.dct_blocks)
    rows = torch.from_numpy(write_rows(y, c, np.array([1, 2, 3, 4], np.int32), 16))
    trainer = Trainer(cfg, device="cpu")
    with torch.no_grad():  # norm1 and norm2 start at 0: every branch would be 0
        for name, p in trainer.model.named_parameters():
            if ".norm1." in name or ".norm2." in name:
                p.uniform_(0.5, 1.5)
    draws = trainer.draw(4)
    first = float(trainer.compute_grads(rows, draws))
    assert float(trainer.compute_grads(rows, draws)) == first
    draws.drop_keep = ~draws.drop_keep
    draws.drop_keep[0] = True  # the first block's rate is 0
    assert float(trainer.compute_grads(rows, draws)) != first
