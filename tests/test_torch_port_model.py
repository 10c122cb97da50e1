"""The port's ViT against the flax ViT with the same parameters.

JAX-initialised parameters are carried across by ``convert.py``; the float32
CPU outputs must match flax to atol 1e-5, rtol 1e-4.  Sizes are cut down:
depth 2, emb 48, 2 heads of 24, an 8-block grid, 5 classes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.models import embeddings as jax_embeddings
from rgbnomore_tpu.models import subblock as jax_subblock
from rgbnomore_tpu.models.vit import EncoderBlock as JaxEncoderBlock
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.models import embeddings, subblock
from rgbnomore_tpu_torch.models.vit import EncoderBlock
from rgbnomore_tpu_torch.ops.attention import attention_plain
from rgbnomore_tpu_torch.train.config import build_model, generate_config

TOL = dict(atol=1e-5, rtol=1e-4)


def _np_params(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _small_cfg(gen):
    cfg = gen("vitti", "dct", modelver=1)
    cfg.model.depth, cfg.model.embed_size = 2, 48
    cfg.model.heads, cfg.model.head_size = 2, 24
    cfg.model.classes, cfg.model.dct_blocks = 5, 8
    return cfg


def _dct_inputs(rng, batch=2, grid=8):
    y = rng.standard_normal((batch, 1, grid, grid, 8, 8)).astype(np.float32)
    c = rng.standard_normal((batch, 2, grid // 2, grid // 2, 8, 8)).astype(np.float32)
    return y, c


@pytest.mark.parametrize("h,w,e", [(14, 14, 192), (4, 4, 48), (3, 5, 8)])
def test_sincos_matches_flax(h, w, e):
    want = np.asarray(jax_embeddings.sincos_position_embedding(h, w, e))
    got = embeddings.sincos_position_embedding(h, w, e).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("patch_dim", [1, 2, 4])
def test_group_and_subblock_match_flax(rng, patch_dim):
    x = rng.standard_normal((2, 1, 8, 8, 8, 8)).astype(np.float32)
    conv, pd, _ = jax_subblock.patch_conversion(8 * patch_dim)
    want = jax_subblock.apply_subblock(jax_subblock.group_blocks(jnp.asarray(x), pd), conv)
    conv_t = None if conv is None else torch.from_numpy(np.array(conv))
    got = subblock.apply_subblock(subblock.group_blocks(torch.from_numpy(x), pd), conv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_embedding_matches_flax(rng):
    y, c = _dct_inputs(rng)
    jax_embeddings.set_bias_family("torch")
    jmod = jax_embeddings.PatchEmbeddingDCTGroup(16, 48)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(c))
    want = np.asarray(jmod.apply(variables, jnp.asarray(y), jnp.asarray(c)))
    tmod = embeddings.PatchEmbeddingDCTGroup(16, 48)
    tmod.load_state_dict(flax_to_state_dict(_np_params(variables)))
    got = tmod(torch.from_numpy(y), torch.from_numpy(c))
    assert got.shape == (2, 16, 48)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_encoder_block_matches_flax(rng):
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    jax_embeddings.set_bias_family("torch")
    jmod = JaxEncoderBlock(48, 2, 24)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = EncoderBlock(48, 2, 24)
    tmod.load_state_dict(flax_to_state_dict(_np_params(variables)))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_vit_logits_match_flax(rng, batch):
    y, c = _dct_inputs(rng, batch)
    jmodel = jax_build_model(_small_cfg(jax_generate_config))
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(y), jnp.asarray(c))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(y), jnp.asarray(c)))
    tmodel = build_model(_small_cfg(generate_config), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np_params(variables)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == (batch, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_attention_swap_gives_same_logits(rng):
    """The check ``chip_smoke.py`` runs on the card (kernel vs plain
    attention in every block) is an identity on the CPU, where both are the
    plain path."""
    y, c = (torch.from_numpy(a) for a in _dct_inputs(rng))
    model = build_model(_small_cfg(generate_config), device="cpu")
    with torch.inference_mode():
        want = model(y, c)
        for i in range(model.depth):
            getattr(model, f"encoder_{i}").mha.attention = attention_plain
        got = model(y, c)
    assert torch.equal(got, want)


def test_seeded_init_is_reproducible():
    cfg = _small_cfg(generate_config)
    a = build_model(cfg, device="cpu").state_dict()
    b = build_model(cfg, device="cpu").state_dict()
    cfg.seed += 1
    other = build_model(cfg, device="cpu").state_dict()
    assert a.keys() == b.keys() == other.keys()
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert not torch.equal(a["encoder_0.mha.qkv.weight"], other["encoder_0.mha.qkv.weight"])
    bound = 1.0 / 48**0.5  # U(+-1/sqrt(fan_in)) for the 48-wide qkv input
    assert a["encoder_0.mha.qkv.weight"].abs().max() <= bound


def test_state_dict_keys_match_flax_tree(rng):
    y, c = _dct_inputs(rng, 1)
    jmodel = jax_build_model(_small_cfg(jax_generate_config))
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), y, c))
    flax_keys = set(flax_to_state_dict(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), variables["params"])))
    torch_keys = set(build_model(_small_cfg(generate_config), device="cpu").state_dict())
    assert flax_keys == torch_keys


@pytest.mark.parametrize("change", [
    lambda cfg: setattr(cfg.model, "version", 2),
    lambda cfg: setattr(cfg.model, "domain", "RGB"),
    lambda cfg: setattr(cfg.model, "patch_size", 8),
    lambda cfg: setattr(cfg.train, "amp", True),
], ids=["embed_type2", "rgb", "patch8_subblocks", "amp"])
def test_unported_configs_raise(change):
    cfg = _small_cfg(generate_config)
    change(cfg)
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
