"""Dropout in the port against flax's, on the CPU.

The JAX ViT drops after the attention projection, after GELU and after mlp2
(``rgbnomore_tpu/models/vit.py:95-106``); the JAX SwinV2 after the patch
embedding and, in each block, after GELU and after mlp2 (``swinv2.py:
286-290, 383-384``).  Flax's ``nn.Dropout`` computes ``select(mask, x /
keep, 0)`` with the division in x's dtype.  Here, with flax's own masks
(captured with ``capture_intermediates``: the mask is ``out != 0``) handed
to the port through ``DropoutMasks``:

- one dropout site is bit-identical to flax's in float32, bf16 and fp16,
  where ``x * (1 / keep)`` is not;
- the ViT (depth 2, emb 64) and SwinV2 (embed 32, depths (2, 2), norms
  perturbed) train-mode logits at drop 0.1 match flax's: float32 at the
  model tests' tolerances (ViT atol 1e-5 / rtol 1e-4, SwinV2 5e-4 / 1e-3),
  bf16 within 2^-4 of the float32 logits' scale of each other, as
  ``tests/test_torch_port_amp.py`` holds them;
- at drop 0 the train-mode forward is the eval-mode one bit for bit and the
  Trainer draws no masks; ``create_state`` no longer refuses a drop rate,
  and a step's masks are a function of (seed, step, rank).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.models import embeddings as jax_embeddings
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from torch_port_support import perturb_norms, settle_inspect_module_walk, torch_threads
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.models.layers import DropoutMasks
from rgbnomore_tpu_torch.train.config import build_model, generate_config
from rgbnomore_tpu_torch.train.loop import Trainer

DROP = 0.1
DTYPES = {"float32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
F32_TOL = {"vit": dict(atol=1e-5, rtol=1e-4), "swin": dict(atol=5e-4, rtol=1e-3)}
BF16_TOL = 2**-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def torch_bias_family():
    """The JAX init's bias family is a global (``set_bias_family``)."""
    jax_embeddings.set_bias_family("torch")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def flax_masks(intermediates: dict, order: list[str]) -> list[torch.Tensor]:
    """The keep masks of flax's dropout sites at the paths ``order`` (each
    ``a/b/Dropout_i``), read from their captured outputs."""
    out = []
    for path in order:
        node = intermediates
        for name in path.split("/"):
            node = node[name]
        out.append(torch.from_numpy(np.asarray(node["__call__"][0]) != 0))
    return out


def apply_train(model, params, y, c, key):
    """A flax train-mode forward (jitted: eagerly SwinV2 takes 3x as long):
    its logits and its dropout outputs."""
    def fwd(params, y, c, key):
        return model.apply(params, y, c, train=True, rngs={"dropout": key},
                           capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout),
                           mutable=["intermediates"])

    logits, state = jax.jit(fwd)(params, y, c, key)
    return logits, state["intermediates"]


@pytest.mark.parametrize("tag", DTYPES)
def test_dropout_site_bit_identical_to_flax(tag, rng):
    tdt, jdt = DTYPES[tag]
    x = jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32) * 3).astype(jdt)
    want = fnn.Dropout(DROP).apply({}, x, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
    mask = torch.from_numpy(np.asarray(want) != 0)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    got = DropoutMasks(masks=[mask]).apply(tx, DROP)
    assert got.dtype == tdt
    assert torch.equal(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(tdt))
    if tag == "bf16":  # the multiplication by 1 / keep rounds differently
        naive = torch.where(mask, tx * (1.0 / (1.0 - DROP)), 0.0)
        assert not torch.equal(naive, got)


def _vit_cfg(gen, tag, drop=DROP):
    cfg = gen("vitti", "dct", modelver=1, amp=tag != "float32", ampdtype="bf16", drop=drop)
    cfg.model.depth, cfg.model.embed_size = 2, 64
    cfg.model.heads, cfg.model.head_size = 2, 32
    cfg.model.classes, cfg.model.dct_blocks = 5, 8
    return cfg


def _swin_cfg(gen, tag, drop=DROP):
    cfg = gen("swinv2", "dct", seed=5, drop=drop)
    cfg.model.depth, cfg.model.heads = (2, 2), (2, 4)
    cfg.model.embed_size, cfg.model.window_size = 32, 4
    cfg.model.pretrained_window_sizes = (0, 0)
    cfg.model.drop_path, cfg.model.classes = 0.0, 10
    cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    cfg.train.amp = tag != "float32"
    cfg.model.amp_dtype = "bf16"
    return cfg


# each model's dropout sites in the order the port reaches them
ORDER = {
    "vit": [f"encoder_{i}/Dropout_{j}" for i in range(2) for j in range(3)],
    "swin": ["Dropout_0"] + [f"layer{i}_block{d}/Dropout_{j}"
                             for i in range(2) for d in range(2) for j in range(2)],
}
CFGS = {"vit": _vit_cfg, "swin": _swin_cfg}


def _inputs(rng):
    y = rng.standard_normal((3, 1, 8, 8, 8, 8)).astype(np.float32) * 50
    c = rng.standard_normal((3, 2, 4, 4, 8, 8)).astype(np.float32) * 50
    return y, c


def _flax_params(arch, y, c):
    jmodel = jax_build_model(CFGS[arch](jax_generate_config, "float32"))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3), y, c))
    if arch == "swin":  # res-post norms start at 0: every block the identity
        params = {"params": perturb_norms(params["params"], np.random.default_rng(3))}
    return params


@pytest.mark.parametrize("tag", ["float32", "bf16"])
@pytest.mark.parametrize("arch", ["vit", "swin"])
def test_train_forward_matches_flax_on_its_masks(arch, tag, rng):
    y, c = _inputs(rng)
    params = _flax_params(arch, y, c)
    key = jax.random.PRNGKey(9)
    want, inter = apply_train(jax_build_model(CFGS[arch](jax_generate_config, tag)), params,
                              y, c, key)
    masks = flax_masks(inter, ORDER[arch])
    assert len(masks) == len(ORDER[arch]) and 0.8 < float(masks[1].float().mean()) < 0.97
    tmodel = build_model(CFGS[arch](generate_config, tag), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(params["params"]))
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(y), torch.from_numpy(c),
                     dropout=DropoutMasks(masks=masks))
        plain = tmodel.eval()(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.float32
    assert not np.allclose(to_np(got), to_np(plain), atol=1e-3)  # the masks did drop
    if tag == "float32":
        np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL[arch])
        return
    # bf16: within BF16_TOL of the float32 logits' scale, on the same masks
    ref, _ = apply_train(jax_build_model(CFGS[arch](jax_generate_config, "float32")), params,
                         y, c, key)
    scale = float(np.abs(to_np(ref)).max())
    np.testing.assert_allclose(to_np(got), to_np(want), atol=BF16_TOL * scale, rtol=BF16_TOL)


@pytest.mark.parametrize("arch", ["vit", "swin"])
def test_drop_zero_is_unchanged(arch, rng):
    """At drop 0 the train-mode forward takes no masks and is the eval-mode
    forward bit for bit; the Trainer makes no dropout generator and its
    draws carry no masks."""
    y, c = (torch.from_numpy(a) for a in _inputs(rng))
    model = build_model(CFGS[arch](generate_config, "float32", drop=0.0), device="cpu")
    with torch.no_grad():
        train = model.train()(y, c)
        evals = model.eval()(y, c)
    assert torch.equal(train, evals)
    trainer = Trainer(CFGS[arch](generate_config, "float32", drop=0.0), device="cpu")
    assert trainer.dropout_masks() is None and trainer.draw(3).dropout is None


@pytest.mark.parametrize("arch", ["vit", "swin"])
def test_dropout_needs_its_masks_in_training(arch, rng):
    y, c = (torch.from_numpy(a) for a in _inputs(rng))
    model = build_model(CFGS[arch](generate_config, "float32"), device="cpu").train()
    with pytest.raises(ValueError, match="DropoutMasks"):
        model(y, c)


@pytest.mark.parametrize("arch", ["vit", "swin"])
def test_create_state_takes_a_drop_rate(arch, rng):
    """``create_state`` at drop 0.1, then the masks of a step: drawn from
    (seed, step, rank), the same for the same step, others for the next."""
    settle_inspect_module_walk()
    trainer = Trainer(CFGS[arch](generate_config, "float32"), device="cpu")
    trainer.create_state(steps_per_epoch=4)
    x = torch.ones((3, 49, 64))

    def masks_at(step):
        trainer.optimizer.count = step
        return trainer.dropout_masks().apply(x, DROP) != 0

    first, again, later = masks_at(0), masks_at(0), masks_at(1)
    assert torch.equal(first, again) and not torch.equal(first, later)
    assert 0.85 < float(first.float().mean()) < 0.95
    trainer.rank = 1  # another rank of a data-parallel run draws its own
    trainer.optimizer.count = 0
    assert not torch.equal(first, trainer.dropout_masks().apply(x, DROP) != 0)
