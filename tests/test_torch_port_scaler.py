"""The port's hand-written fp16 loss scaler against the JAX package's.

- Every case of ``tests/test_scaler.py`` on ``rgbnomore_tpu_torch.train.
  scaler`` and the port's ``Trainer``: backoff, growth after the interval,
  the counter reset, the clamp to [2^-4, 2^18], ``all_finite``, an fp16
  step that trains and carries the scaler's state, an overflow that skips
  the update (parameters, AdamW moments and AdamW's count bit-identical,
  the schedule's count advanced, the scale backed off), and no scaler
  state for bf16 and float32.
- ``update_loss_scale`` against the JAX one over a seeded run of finite
  and non-finite steps.
- A 4-step fp16 lockstep of ``Trainer.train_step`` against the JAX
  ``Trainer`` at the tiny SwinV2 configuration of
  ``torch_port_support.tiny_swin_cfg``, on the rows and draws of
  ``tests/test_torch_port_swin_train.py``: the first step overflows at the
  scale of 2^15 on both sides, the second has an infinite weight on both
  sides, the last two update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from rgbnomore_tpu.train import scaler as jax_ls
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.train import scaler as ls
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer
from rgbnomore_tpu_torch.train.optim import warmup_cosine_schedule

TRUE, FALSE = torch.tensor(True), torch.tensor(False)


def test_constants_match_jax():
    assert (ls.GROWTH, ls.BACKOFF, ls.GROWTH_INTERVAL, ls.SCALE_MIN, ls.SCALE_MAX) == (
        jax_ls.GROWTH, jax_ls.BACKOFF, jax_ls.GROWTH_INTERVAL, jax_ls.SCALE_MIN,
        jax_ls.SCALE_MAX)
    st, jst = ls.init_loss_scale(), jax_ls.init_loss_scale()
    assert float(st.scale) == float(jst.scale) == 2.0**15
    assert st.scale.dtype == torch.float32 and st.good_steps.dtype == torch.int32
    assert int(st.good_steps) == int(jst.good_steps) == 0


def test_backoff_on_overflow():
    st = ls.init_loss_scale(1024.0)
    st2 = ls.update_loss_scale(st, FALSE)
    assert float(st2.scale) == pytest.approx(1024.0 * 0.625)
    assert int(st2.good_steps) == 0


def test_growth_after_interval():
    st = ls.init_loss_scale(1024.0)
    # growth_interval - 1 finite steps: unchanged
    for _ in range(ls.GROWTH_INTERVAL - 1):
        st = ls.update_loss_scale(st, TRUE)
    assert float(st.scale) == 1024.0
    st = ls.update_loss_scale(st, TRUE)
    assert float(st.scale) == pytest.approx(1024.0 * 1.6)
    assert int(st.good_steps) == 0  # counter resets after growth


def test_growth_counter_resets_on_overflow():
    st = ls.init_loss_scale(1024.0)
    for _ in range(10):
        st = ls.update_loss_scale(st, TRUE)
    assert int(st.good_steps) == 10
    st = ls.update_loss_scale(st, FALSE)
    assert int(st.good_steps) == 0


def test_scale_clamped_to_reference_range():
    # repeated overflows floor at 2**-4 (clip_gradscaler's min)
    st = ls.init_loss_scale(2.0**-3)
    st = ls.update_loss_scale(st, FALSE)
    st = ls.update_loss_scale(st, FALSE)
    assert float(st.scale) == 2.0**-4
    # growth caps at 2**18 (its max)
    st = ls.LossScaleState(scale=torch.tensor(2.0**18),
                           good_steps=torch.tensor(ls.GROWTH_INTERVAL - 1, dtype=torch.int32))
    st = ls.update_loss_scale(st, TRUE)
    assert float(st.scale) == 2.0**18


def test_all_finite():
    assert bool(ls.all_finite([torch.ones(3), torch.zeros((2, 2))]))
    assert not bool(ls.all_finite([torch.ones(3), torch.tensor([float("inf"), 0.0])]))
    assert not bool(ls.all_finite([torch.tensor([float("nan")])]))
    assert bool(ls.all_finite([]))


def test_update_matches_jax_over_a_run():
    """A run of 2,604 steps from a scale near the cap: growth after 600
    finite steps, a backoff that resets the count, a growth stopped by the
    clamp at 2^18, three backoffs in a row; each step's scale and good-step
    count equal the JAX package's."""
    flags = [True] * 700 + [False] + [True] * 650 + [False] * 3 + [True] * 1250
    st, jst = ls.init_loss_scale(1.5 * 2.0**17), jax_ls.init_loss_scale(1.5 * 2.0**17)
    jax_update = jax.jit(jax_ls.update_loss_scale)
    scales = set()
    for flag in flags:
        st = ls.update_loss_scale(st, torch.tensor(flag))
        jst = jax_update(jst, jnp.asarray(flag))
        assert float(st.scale) == float(jst.scale)
        assert int(st.good_steps) == int(jst.good_steps)
        scales.add(float(st.scale))
    assert 2.0**18 in scales and len(scales) >= 5


def adam_count(adamw: torch.optim.Optimizer, p: torch.Tensor) -> int:
    """AdamW's update count for ``p``: 0 before its first step makes the
    state."""
    state = adamw.state.get(p, {})
    return int(float(state["step"])) if "step" in state else 0


def _tiny_fp16_trainer(batch=4):
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=batch, amp=True, ampdtype="fp16")
    cfg.model.depth = 1
    cfg.model.dct_blocks = 4
    cfg.model.classes = 5
    cfg.train.warmup = 2
    trainer = Trainer(cfg, device="cpu")
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=4)
    return trainer, cfg


def _rows(cfg, batch):
    y, c = synthetic_planes(np.random.default_rng(0), batch, cfg.model.dct_blocks)
    labels = (np.arange(batch) % cfg.model.classes).astype(np.int32)
    return torch.from_numpy(write_rows(y, c, labels, 16))


def test_fp16_step_trains_and_carries_scaler_state():
    trainer, cfg = _tiny_fp16_trainer()
    assert trainer.compute_dtype == torch.float16
    assert trainer.loss_scale is not None
    s0 = float(trainer.loss_scale.scale)
    loss = trainer.train_step(_rows(cfg, 4))
    assert np.isfinite(float(loss))
    assert trainer.step == 1
    assert float(trainer.loss_scale.scale) == s0  # finite step: unchanged
    assert int(trainer.loss_scale.good_steps) == 1


def test_fp16_overflow_skips_update_and_backs_off():
    """An infinite weight makes the gradients non-finite: the step keeps the
    parameters and AdamW's moments bit-identical and its count at 0,
    advances the schedule's count, and backs off the scale."""
    trainer, cfg = _tiny_fp16_trainer()
    with torch.no_grad():
        trainer.model.patchembed.projection.weight[0, 0] = float("inf")
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    s0 = float(trainer.loss_scale.scale)
    loss = trainer.train_step(_rows(cfg, 4))
    assert not np.isfinite(float(loss))
    for k, p in trainer.model.named_parameters():
        assert torch.equal(p, before[k]), k  # update skipped
    assert trainer.step == trainer.optimizer.count == 1  # schedule still advanced
    assert float(trainer.loss_scale.scale) == pytest.approx(s0 * 0.625)
    assert int(trainer.loss_scale.good_steps) == 0
    # GradScaler parity on the optimizer state: AdamW never stepped, so its
    # count is 0 and its moments are not even made (0, as optax's at init)
    assert all(adam_count(trainer.optimizer.opt, p) == 0 for p in trainer.model.parameters())
    assert not any(trainer.optimizer.opt.state[p] for p in trainer.model.parameters())


def test_skip_after_updates_keeps_moments_bit_identical():
    """A skipped step after two updates: every parameter and AdamW state
    tensor bit-identical to before it; the next finite step updates again."""
    trainer, cfg = _tiny_fp16_trainer()
    rows = _rows(cfg, 4)
    trainer.train_step(rows)
    trainer.train_step(rows)
    adamw = trainer.optimizer.opt
    weight = trainer.model.patchembed.projection.weight
    saved = weight.detach()[0, 0].clone()
    with torch.no_grad():
        weight[0, 0] = float("inf")
    params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    states = {k: {n: t.clone() for n, t in adamw.state[p].items()}
              for k, p in trainer.model.named_parameters()}
    trainer.train_step(rows)
    for k, p in trainer.model.named_parameters():
        assert torch.equal(p, params[k]), k
        assert all(torch.equal(t, states[k][n]) for n, t in adamw.state[p].items()), k
    assert trainer.optimizer.count == 3 and adam_count(adamw, weight) == 2
    with torch.no_grad():
        weight[0, 0] = saved
    assert np.isfinite(float(trainer.train_step(rows)))
    assert adam_count(adamw, weight) == 3 and int(trainer.loss_scale.good_steps) == 1


@pytest.mark.parametrize("amp,dtype", [(True, "bf16"), (False, "bf16")], ids=["bf16", "f32"])
def test_bf16_and_f32_have_no_scaler_state(amp, dtype):
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=4, amp=amp, ampdtype=dtype)
    cfg.model.depth = 1
    cfg.model.dct_blocks = 4
    trainer = Trainer(cfg, device="cpu")
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=2)
    assert trainer.loss_scale is None
    assert trainer.compute_dtype == (torch.bfloat16 if amp else torch.float32)


# The fp16 lockstep.  The scaler's state, the schedule's count and AdamW's
# count agree exactly, step for step (the first step overflows on both
# sides at the scale of 2^15, the second is skipped by its infinite
# weight).  Losses agree within 1e-3 relative: fp16 rounds every Linear's
# output and, in JAX's SwinV2 einsum path, the attention logits, which the
# port's window kernel keeps in float32 as the JAX package's Pallas call
# site does.  Parameters: Adam moves each by about lr * g / (|g| + eps),
# the same where g is far above fp16's rounding; where it is not (the q and
# k thirds of the later stages' qkv kernels, with gradients near 1e-9), the
# two frameworks' roundings drive it apart.  So every entry is held to the
# sum of the learning rates (what the steps can move it at most), and at
# most NOISY_SHARE of the entries may lie beyond PARAM_ATOL (1.4% did).
FP16_LOSS_RTOL = 1e-3
FP16_PARAM_ATOL = 1e-4
NOISY_SHARE = 0.03


def _counts(opt_state):
    """(schedule count, Adam count) of an optax state."""
    found = {}

    def walk(x):
        if isinstance(x, optax.ScaleByScheduleState):
            found["sched"] = int(x.count)
        elif isinstance(x, optax.ScaleByAdamState):
            found["adam"] = int(x.count)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(opt_state)
    return found["sched"], found["adam"]


def _set_jax_kernel(state, value):
    params = jax.tree.map(np.array, state.params)
    params["patch_embed"]["projection"]["kernel"][0, 0] = value
    return state.replace(params=jax.tree.map(jnp.asarray, params))


def test_fp16_lockstep_with_jax_through_an_overflow():
    jt = jax_swin_trainer(amp_dtype="fp16")
    cfg = tiny_swin_cfg(generate_config, amp_dtype="fp16")
    grid, b = cfg.model.dct_blocks, cfg.train.batch_size
    y, c = synthetic_planes(np.random.default_rng(0), b, grid)
    rows = write_rows(y, c, np.array([1, 7, 3, 7], np.int32), 16)

    trainer = port_swin_trainer(jt, cfg)
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    assert trainer.compute_dtype == torch.float16 and jt._fp16_scaler
    step_fn = jt._fused_train_step()
    base_rng = jax.random.PRNGKey(cfg.seed + 1)
    schedule = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup, 10)
    state = jax.tree.map(lambda x: jnp.asarray(np.array(x)), jt.state)
    weight = trainer.model.patch_embed.projection.weight  # kernel (in, out) transposed
    saved = float(weight.detach()[0, 0])
    adamw = trainer.optimizer.opt
    for step in range(4):
        if step == 1:  # an infinite weight on both sides
            with torch.no_grad():
                weight[0, 0] = float("inf")
            state = _set_jax_kernel(state, np.inf)
        draws = jax_step_draws(jt, base_rng, step, b, grid)
        state, metrics = step_fn(state, jt.put_batch({"packed": rows}), base_rng)
        loss = float(trainer.train_step(torch.from_numpy(rows), draws))
        if step == 1:
            assert not np.isfinite(loss) and not np.isfinite(float(metrics["loss"]))
            with torch.no_grad():
                weight[0, 0] = saved
            state = _set_jax_kernel(state, saved)
        else:
            np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=FP16_LOSS_RTOL)
        assert float(trainer.loss_scale.scale) == float(state.loss_scale.scale)
        assert int(trainer.loss_scale.good_steps) == int(state.loss_scale.good_steps)
        sched, adam = _counts(state.opt_state)
        assert trainer.optimizer.count == sched == step + 1
        assert adam_count(adamw, weight) == adam
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params))
        lr_sum = sum(schedule(s) for s in range(step + 1))
        beyond, total = 0, 0
        for name, p in trainer.model.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert diff.max() <= lr_sum, f"{name} step {step}: {diff.max()}"
            beyond += int((diff > FP16_PARAM_ATOL).sum())
            total += diff.size
        assert beyond <= NOISY_SHARE * total, f"step {step}: {beyond} of {total} entries"
    # the scale backed off twice: the first step overflowed at 2^15 in both
    # frameworks, the second had the infinite weight
    assert float(trainer.loss_scale.scale) == 2.0**15 * 0.625**2
    assert adam_count(adamw, weight) == 2
