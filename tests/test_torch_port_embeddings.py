"""The port's separate (embed_type 2) and concatenated (embed_type 3) DCT
embeddings, the ViT built on each, and SwinV2's absolute position embedding,
against the JAX package's on the CPU.

Parameters are flax's, carried across by ``convert.py``; inputs come from a
numpy seed.  Sizes are cut down as ``test_torch_port_model.py`` cuts them:
depth 2, emb 48, 2 heads of 24, an 8-block grid, 5 classes.

- Each embedding against flax at atol 1e-5, rtol 1e-4, with sub-blocks and
  without, at patch 16 and, where JAX allows it, patch 8 (the separate
  embedding without sub-blocks needs a chroma patch of at least one block).
- ViT logits for each ``ver`` at batch 1 and 3, and the ``state_dict`` keys
  against the flax tree for each.
- SwinV2 with ``ape`` at the tiny configuration of
  ``test_torch_port_swin.py``, at its 5e-4 / 1e-3.
- Both packages refuse the sub-block separate embedding at a width that is
  not a multiple of 6 (emb 40: 24 + 12 features against a residual of 40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import perturb_norms, tiny_swin_cfg
from rgbnomore_tpu.models import embeddings as jax_embeddings
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.models import embeddings
from rgbnomore_tpu_torch.train.config import build_model, generate_config

TOL = dict(atol=1e-5, rtol=1e-4)
SWIN_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_torch_port_swin.py


def _np_params(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _inputs(rng, batch=2, grid=8):
    y = rng.standard_normal((batch, 1, grid, grid, 8, 8)).astype(np.float32)
    c = rng.standard_normal((batch, 2, grid // 2, grid // 2, 8, 8)).astype(np.float32)
    return y, c


def _small_cfg(gen, ver, subblock=True, patch=16):
    cfg = gen("vitti", "dct", modelver=ver, subblock=subblock)
    cfg.model.depth, cfg.model.embed_size = 2, 48
    cfg.model.heads, cfg.model.head_size = 2, 24
    cfg.model.classes, cfg.model.dct_blocks = 5, 8
    cfg.model.patch_size = patch
    return cfg


# (name, JAX module, port module, constructor kwargs, tokens on the 8-block grid)
EMBED_CASES = [
    ("separate_p16", "PatchEmbeddingDCTSeparate", dict(patch_size=16), 16),
    ("separate_subblock_p16", "PatchEmbeddingDCTSeparateSubblock", dict(patch_size=16), 16),
    ("separate_subblock_p8", "PatchEmbeddingDCTSeparateSubblock", dict(patch_size=8), 64),
    ("concat_p16", "PatchEmbeddingDCTConcat", dict(patch_size=16), 16 + 2 * 4),
    ("concat_p16_no_subblock", "PatchEmbeddingDCTConcat",
     dict(patch_size=16, use_subblock=False), 16 + 2 * 4),
    ("concat_p8", "PatchEmbeddingDCTConcat", dict(patch_size=8), 64 + 2 * 16),
    ("concat_p8_no_subblock", "PatchEmbeddingDCTConcat",
     dict(patch_size=8, use_subblock=False), 64 + 2 * 16),
]


@pytest.mark.parametrize("name,cls,kw,tokens", EMBED_CASES, ids=[c[0] for c in EMBED_CASES])
def test_embedding_matches_flax(rng, name, cls, kw, tokens):
    y, c = _inputs(rng)
    jax_embeddings.set_bias_family("torch")
    jmod = getattr(jax_embeddings, cls)(emb_size=48, **kw)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(c))
    want = np.asarray(jmod.apply(variables, jnp.asarray(y), jnp.asarray(c)))
    tmod = getattr(embeddings, cls)(emb_size=48, **kw)
    tmod.load_state_dict(flax_to_state_dict(_np_params(variables)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(y), torch.from_numpy(c))
    assert got.shape == want.shape == (2, tokens, 48)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_separate_block_order_is_c_pdh_pdw(rng):
    """Each ``linear_y{i}`` reads the block ``(pdh, pdw)`` of ``i = 2 pdh +
    pdw`` and each ``linear_c{i}`` chroma channel ``i``: a coefficient put in
    one block moves only that block's Linear."""
    mod = embeddings.PatchEmbeddingDCTSeparate(16, 48)
    y = torch.zeros(1, 1, 2, 2, 8, 8)
    c = torch.zeros(1, 2, 1, 1, 8, 8)
    y[0, 0, 1, 0, 0, 0] = 1.0  # block (pdh, pdw) = (1, 0) of the one patch: linear_y2
    c[0, 1, 0, 0, 0, 0] = 1.0  # chroma channel 1: linear_c1
    blocks_y = mod._blocks(y, mod.pd_y)
    blocks_c = mod._blocks(c, mod.pd_c)
    assert [int(blocks_y[0, 0, 0, i].abs().sum()) for i in range(4)] == [0, 0, 1, 0]
    assert [int(blocks_c[0, 0, 0, i].abs().sum()) for i in range(2)] == [0, 1]


VIT_CASES = [(2, True, 16), (2, False, 16), (3, True, 16), (3, False, 16), (2, True, 8),
             (3, True, 8)]
VIT_IDS = [f"ver{v}_{'subblock' if s else 'no_subblock'}_p{p}" for v, s, p in VIT_CASES]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("ver,subblock,patch", VIT_CASES, ids=VIT_IDS)
def test_vit_logits_match_flax(rng, ver, subblock, patch, batch):
    y, c = _inputs(rng, batch)
    jax_embeddings.set_bias_family("torch")
    jmodel = jax_build_model(_small_cfg(jax_generate_config, ver, subblock, patch))
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(y), jnp.asarray(c))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(y), jnp.asarray(c)))
    tmodel = build_model(_small_cfg(generate_config, ver, subblock, patch), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np_params(variables)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == (batch, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ver,subblock,patch", VIT_CASES, ids=VIT_IDS)
def test_state_dict_keys_match_flax_tree(rng, ver, subblock, patch):
    y, c = _inputs(rng, 1)
    jmodel = jax_build_model(_small_cfg(jax_generate_config, ver, subblock, patch))
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), y, c))
    flax = flax_to_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                           variables["params"]))
    port = build_model(_small_cfg(generate_config, ver, subblock, patch),
                       device="cpu").state_dict()
    assert set(flax) == set(port)
    assert all(flax[k].shape == port[k].shape for k in flax)


@pytest.mark.parametrize("bias_init", ["torch", "zeros"])
@pytest.mark.parametrize("ver,subblock", [(2, True), (2, False), (3, True)])
def test_init_covers_the_new_linears(ver, subblock, bias_init):
    """``init_weights`` draws every Linear of each embedding from the
    generator, U(+-1/sqrt(fan_in)), biases zero in the ``zeros`` family."""
    cfg = _small_cfg(generate_config, ver, subblock)
    cfg.model.bias_init = bias_init
    model = build_model(cfg, device="cpu")
    linears = [m for m in model.patchembed.modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == {(2, True): 3, (2, False): 7, (3, True): 2}[(ver, subblock)]
    for m in linears:
        bound = 1.0 / m.in_features ** 0.5
        assert 0 < m.weight.abs().max() <= bound
        assert (m.bias.abs().max() == 0) == (bias_init == "zeros")
        assert m.bias.abs().max() <= bound


def test_both_refuse_widths_that_do_not_divide_by_6(rng):
    """emb 40: projection_y 24 + projection_c 12 = 36 features against the
    residual's 40.  JAX fails at the add; the port refuses at construction,
    naming both widths."""
    y, c = _inputs(rng, 1)
    jmod = jax_embeddings.PatchEmbeddingDCTSeparateSubblock(16, 40)
    with pytest.raises((TypeError, ValueError)):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(c))
    with pytest.raises(ValueError, match="24 \\+ 12 = 36 wide.*needs 40"):
        embeddings.PatchEmbeddingDCTSeparateSubblock(16, 40)
    cfg = _small_cfg(generate_config, 2)
    cfg.model.embed_size = 40
    with pytest.raises(ValueError, match="multiple of 6"):
        build_model(cfg, device="cpu")


def test_concat_gives_294_tokens_on_the_vit_grid():
    """ViT's 28x28 block grid at patch 16: 14x14 luma tokens and 7x7 per
    chroma channel."""
    mod = embeddings.PatchEmbeddingDCTConcat(16, 48)
    y, c = torch.zeros(1, 1, 28, 28, 8, 8), torch.zeros(1, 2, 14, 14, 8, 8)
    with torch.inference_mode():
        assert tuple(mod(y, c).shape) == (1, 294, 48)


def test_swin_ape_logits_match_jax(rng):
    """SwinV2 with ``ape`` at the tiny every-branch configuration; the
    LayerNorms perturbed (norm1 and norm2 start at 0) and the embedding
    drawn at N(0, 1), so that it moves the logits."""
    cfg_jax = tiny_swin_cfg(jax_generate_config)
    cfg = tiny_swin_cfg(generate_config)
    cfg_jax.model.ape = cfg.model.ape = True
    y = rng.uniform(-1, 1, (3, 1, 8, 8, 8, 8)).astype(np.float32)
    c = rng.uniform(-1, 1, (3, 2, 4, 4, 8, 8)).astype(np.float32)
    jax_embeddings.set_bias_family("torch")
    jmodel = jax_build_model(cfg_jax)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(6), jnp.asarray(y), jnp.asarray(c))
    params = perturb_norms(jax.tree.map(np.asarray, params["params"]), np.random.default_rng(3))
    assert params["absolute_pos_embed"].shape == (1, 16 * 16, 32)
    params["absolute_pos_embed"] = rng.standard_normal((1, 256, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(y), jnp.asarray(c)))
    model = build_model(cfg, device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(y), torch.from_numpy(c)).numpy()
        model.absolute_pos_embed.zero_()
        without = model(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, **SWIN_TOL)
    assert np.abs(got - without).max() > 10 * SWIN_TOL["atol"]  # the embedding counts


def test_swin_ape_init_is_truncated_normal():
    cfg = tiny_swin_cfg(generate_config)
    cfg.model.ape = True
    ape = build_model(cfg, device="cpu").absolute_pos_embed
    assert tuple(ape.shape) == (1, 256, 32)
    # flax's truncated_normal(0.02): std 0.02, cut at 2 x 0.02 / 0.8796
    assert 0 < ape.abs().max() <= 2 * 0.02 / 0.87962566 + 1e-6
    assert 0.018 < float(ape.detach().std()) < 0.022
    cfg.model.ape = False
    assert build_model(cfg, device="cpu").absolute_pos_embed is None
