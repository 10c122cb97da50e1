"""Support shared by the port's tests (``tests/test_torch_port_*.py``)."""

import contextlib
import inspect
import sys


def settle_inspect_module_walk() -> None:
    """Take this process's first walk of ``inspect.getmodule`` over
    ``sys.modules`` now, where its fault is harmless.

    ``tests/test_torch_import.py`` installs a torchvision stub whose module
    ``__getattr__`` answers ``__file__`` with a function.  The first walk in
    a process that meets it raises ``AttributeError``; inspect has cached
    the stub's entry by then, so every later walk skips it.  torch walks
    when it first imports ``torch._dynamo``, which the first
    ``torch.optim`` optimizer in the process does.  Call this before a test
    builds one, so that the outcome does not hang on which test files ran
    earlier in the same process.
    """
    try:
        inspect.getmodule(sys._getframe(), "<settle>")
    except AttributeError:
        pass


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on a float32 tensor: round to nearest with ties
    away from zero, keeping 10 mantissa bits, by adding half of the 13
    dropped bits' unit to the bit pattern and zeroing the low 13 bits (the
    sign bit stays apart from the magnitude, so negatives round the same
    way)."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """What the tensor core reads of a float32 register as TF32: the low
    13 bits dropped."""
    import torch

    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as the port's 3xTF32 kernels compute it (``csrc/
    tf32_mma.cuh``): the cross terms, then hi x hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_read(a - a_hi), tf32_read(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def mm_1xtf32(a, b):
    """``a @ b`` in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def jax_rgb_policy(aug, key, batch):
    """The draws that the JAX ``RandAugmentRGB(key, img)`` makes inside its
    ops (``augment/rgb.py:349-376``), as the port's ``draw_policy`` tuple
    ``(idx, sign, cut_ch, cut_cw, drop)`` of (batch, num_ops) numpy arrays:
    one key a sample, each round split in four (the next key, the op, the
    sign, the op's own key); Cutout splits the op's key into its row and
    column keys, ChromaDrop draws its bit from the op's key."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    n = len(aug.ops_list)
    h, w = aug.image_hw
    signed = jnp.asarray(aug._signed)

    def rounds(rng):
        def body(rng, _):
            rng, k_op, k_sign, k_inner = jax.random.split(rng, 4)
            idx = jax.random.randint(k_op, (), 0, n)
            sign = jnp.where(jax.random.bernoulli(k_sign) & (signed[idx] > 0), -1.0, 1.0)
            kh, kw = jax.random.split(k_inner)
            return rng, (idx, sign, jax.random.randint(kh, (), 0, h),
                         jax.random.randint(kw, (), 0, w), jax.random.bernoulli(k_inner))

        return jax.lax.scan(body, rng, None, length=aug.num_ops)[1]

    outs = jax.vmap(rounds)(jax.random.split(key, batch))
    dtypes = (np.int32, np.float32, np.int32, np.int32, np.bool_)
    return tuple(np.asarray(o).astype(dt) for o, dt in zip(outs, dtypes))


def jax_step_draws(trainer, base_rng, step, batch, grid):
    """The draws of the JAX Trainer's step ``step`` (``loop.py:247-263``,
    ``pipeline.py:399-404``; RGB: ``pipeline.py:208-212``) as the port's
    ``StepDraws``: fold the step into the base key, split it in three
    (augment, mixup, dropout), split the augment key in two (flip, policy).
    The dropout key is not used: the tests run without drop path.  ``grid``
    is the DCT block grid; an RGB trainer's policy is
    :func:`jax_rgb_policy`'s at its input size."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from rgbnomore_tpu.augment.randaugment import RandAugmentDCT
    from rgbnomore_tpu.augment.rgb import RandAugmentRGB
    from rgbnomore_tpu_torch.train.loop import StepDraws

    k_aug, k_mix, _ = jax.random.split(jax.random.fold_in(base_rng, step), 3)
    k_flip, k_pol = jax.random.split(k_aug)
    flip = jax.random.bernoulli(k_flip, 0.5, (batch,))
    cfg = trainer.cfg
    if cfg.model.domain == "RGB":
        size = cfg.model.input_size
        aug = RandAugmentRGB(ops_list=list(cfg.train.auglist), num_ops=cfg.train.num_ops,
                             magnitude=cfg.train.augstr, image_hw=(size, size), fill=128.0)
        policy = jax_rgb_policy(aug, k_pol, batch)
    else:
        aug = RandAugmentDCT(ops_list=list(cfg.train.auglist), num_ops=cfg.train.num_ops,
                             magnitude=cfg.train.augstr, grid=grid)
        policy = aug.draw_policy(k_pol, batch, grid, grid)
    u = jax.random.beta(k_mix, cfg.train.mixup_alpha, cfg.train.mixup_alpha)
    return StepDraws(torch.from_numpy(np.array(flip)),
                     tuple(torch.from_numpy(np.array(p)) for p in policy),
                     float(jnp.maximum(u, 1.0 - u)))


def tiny_swin_cfg(gen, batch=4, classes=10, drop_path=0.0, amp_dtype=None, window16=False):
    """A SwinV2 config that reaches every branch at a tiny size, from
    ``gen`` (the JAX package's or the port's ``generate_config``): depths
    (2, 2, 2), heads (2, 4, 8), embed 32, window 4, an 8x8 block grid (16x16
    tokens: 16 windows, then 4, each stage's odd block shifted, stage 3
    clamped to one window), in float32, or with ``amp_dtype`` ("bf16",
    "fp16") under AMP in it.  ``window16``: SwinV2-B/w16's window instead,
    depths (2, 2, 2, 2), heads (2, 2, 4, 4), embed 16, a 16x16 block grid
    (32x32 tokens: 4 windows of 256 tokens, the odd block shifted by 8, then
    one of 256, 64 and 16 tokens)."""
    cfg = gen("swinv2", "dct", batchsize=batch, epochs=1, warmup_steps=2, seed=5)
    cfg.model.depth, cfg.model.heads = (2, 2, 2), (2, 4, 8)
    cfg.model.embed_size, cfg.model.window_size = 32, 4
    cfg.model.pretrained_window_sizes = (0, 0, 0)
    cfg.model.drop_path, cfg.model.classes = drop_path, classes
    cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    if window16:
        cfg.model.depth, cfg.model.heads = (2, 2, 2, 2), (2, 2, 4, 4)
        cfg.model.embed_size, cfg.model.window_size = 16, 16
        cfg.model.pretrained_window_sizes = (0, 0, 0, 0)
        cfg.model.dct_blocks, cfg.model.input_size = 16, 128
    cfg.train.amp = amp_dtype is not None
    if amp_dtype is not None:
        cfg.model.amp_dtype = amp_dtype
    return cfg


def perturb_norms(params, rng):
    """A copy of a flax parameter tree with every LayerNorm scale drawn from
    U(0.5, 1.5) and its bias from N(0, 0.1^2).  SwinV2's init starts norm1
    and norm2 at scale 0, where every block is the identity and no attention
    reaches the logits."""
    import numpy as np

    out = {}
    for name, value in params.items():
        if isinstance(value, dict):
            out[name] = perturb_norms(value, rng)
        else:
            out[name] = np.asarray(value)
    if "scale" in out:
        out["scale"] = rng.uniform(0.5, 1.5, out["scale"].shape).astype(np.float32)
        out["bias"] = (rng.standard_normal(out["bias"].shape) * 0.1).astype(np.float32)
    return out


def jax_swin_trainer(amp_dtype=None, window16=False):
    """The JAX Trainer (``transfer="cropped"``) at :func:`tiny_swin_cfg`
    (with ``amp_dtype``, ``window16``), its LayerNorms perturbed.  Its ``model.init`` runs under ``jax.jit`` (10 s
    here, 30 s eagerly; the same parameters)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from rgbnomore_tpu.train import loop
    from rgbnomore_tpu.train.config import generate_config
    from rgbnomore_tpu.train.steps import TrainState

    def create_train_state(model, cfg, tx, rng, example_batch):
        params = jax.jit(model.init)(rng, *example_batch)["params"]
        return TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    trainer = loop.Trainer(tiny_swin_cfg(generate_config, amp_dtype=amp_dtype,
                                         window16=window16),
                           devices=jax.devices()[:1], transfer="cropped", fused_aug=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "create_train_state", create_train_state)
        trainer.create_state(steps_per_epoch=10)
    params = perturb_norms(jax.tree.map(np.asarray, trainer.state.params),
                           np.random.default_rng(3))
    trainer.state = trainer.state.replace(params=jax.tree.map(jnp.asarray, params))
    return trainer


def port_swin_trainer(jax_trainer, cfg):
    """The port's CPU Trainer for ``cfg`` with the JAX trainer's parameters."""
    import jax
    import numpy as np

    from rgbnomore_tpu_torch.convert import flax_to_state_dict
    from rgbnomore_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, jax_trainer.state.params)))
    return trainer


def write_corpus(root, n: int = 16, size: int = 64):
    """``n`` synthetic ``size`` x ``size`` JPEGs across 4 classes, written
    by the port's codec (``tests/test_distributed.py``'s corpus), and their
    ``index.csv``; returns the index's path."""
    from pathlib import Path

    import numpy as np

    from rgbnomore_tpu_torch import codec

    root = Path(root)
    rng = np.random.default_rng(7)
    rows = ["Filepath,Label"]
    ys, xs = np.mgrid[0:size, 0:size]
    for i in range(n):
        cls = i % 4
        img = np.stack([
            (128 + 80 * np.sin(ys / (2 + cls)) * np.cos(xs / (3 + cls))).astype(np.uint8),
            (128 + 50 * np.cos(xs / (2 + cls)) + rng.integers(-9, 9)).astype(np.uint8),
            (128 + 50 * np.sin(ys / (4 + cls))).astype(np.uint8),
        ])
        p = root / f"img_{i}.jpg"
        codec.write_tensor(p, img, quality=92)
        rows.append(f"{p},{cls}")
    index = root / "index.csv"
    index.write_text("\n".join(rows) + "\n")
    return index


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's CPU ops on ``n`` threads inside the block: the trainer
    tests' models are small, and the test run shares the cores between
    several workers."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def launches(kernel: str) -> int:
    """The launches of ``kernel`` (a wrapper's name) that the port has
    counted, ``rgbnm.launch.<kernel>`` in ``utils/profiling.totals()``."""
    from rgbnomore_tpu_torch.utils import profiling

    return profiling.totals()["counters"].get(f"rgbnm.launch.{kernel}", 0)
