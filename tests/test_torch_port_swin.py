"""The port's SwinV2 against the JAX package's, on the CPU.

- The coords table, the relative position index and the shift mask: exact.
- ``window_partition``, ``window_reverse`` and ``ungroup_blocks``: exact.
- The patch-4 DCT embedding (sub-blocks, no sincos, LayerNorm): 1e-5.
- ``DropPath`` with a given keep mask against JAX's formula.
- ``SwinTransformerV2`` logits with weights from ``convert.py`` at a tiny
  configuration that reaches every branch (depths (2, 2, 2), heads (2, 4,
  8), embed 32, window 4, an 8x8 block grid: 16 windows, then 4, each
  stage's odd block shifted, stage 3 clamped to one window), at atol 5e-4,
  rtol 1e-3 (``tests/test_swin_import.py:95``).  The JAX init starts norm1
  and norm2 at scale 0, where every block is the identity and no attention
  reaches the logits, so every LayerNorm is perturbed first.  Measured:
  1.5e-7 abs.  The same at SwinV2-B/w16's window 16 (depths (2, 2, 2, 2),
  heads (2, 2, 4, 4), embed 16, a 16x16 block grid): 256-token windows,
  shifted and unshifted, then one of 256, 64 and 16 tokens.
- The port's decay set equals JAX's ``kernel_mask`` on the SwinV2 tree.
- ``Trainer.evaluate`` against the JAX ``Trainer`` (``transfer="cropped"``)
  on ``chip_smoke.write_rows`` rows, ``evaluate_model`` on tiny JPEGs
  through the whole-image resize, and SwinV2's loaders.  The train step's
  lockstep is in ``test_torch_port_swin_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_support import jax_swin_trainer, perturb_norms, port_swin_trainer, tiny_swin_cfg
from rgbnomore_tpu import codec as jax_codec
from rgbnomore_tpu.models import swinv2 as jax_swin
from rgbnomore_tpu.models.embeddings import PatchEmbeddingDCTGroup as JaxPatchEmbed
from rgbnomore_tpu.models.subblock import ungroup_blocks as jax_ungroup
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.train.loop import make_loaders as jax_make_loaders
from rgbnomore_tpu.train.optim import kernel_mask
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.eval import evaluate_model
from rgbnomore_tpu_torch.models import swinv2
from rgbnomore_tpu_torch.models.embeddings import PatchEmbeddingDCTGroup
from rgbnomore_tpu_torch.models.subblock import ungroup_blocks
from rgbnomore_tpu_torch.train.config import build_model, generate_config
from rgbnomore_tpu_torch.train.loop import make_loaders
from rgbnomore_tpu_torch.train.optim import decay_parameter_names

LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("ws,pre", [(4, 0), (8, 0), (8, 12), (2, 0)])
def test_coords_table_and_index_exact(ws, pre):
    np.testing.assert_array_equal(swinv2._relative_coords_table(ws, pre),
                                  jax_swin._relative_coords_table(ws, pre))
    np.testing.assert_array_equal(swinv2._relative_position_index(ws),
                                  jax_swin._relative_position_index(ws))


@pytest.mark.parametrize("h,ws,shift", [(16, 4, 2), (64, 8, 4), (32, 8, 4), (8, 4, 2)])
def test_shift_mask_exact(h, ws, shift):
    np.testing.assert_array_equal(swinv2._shift_attn_mask(h, h, ws, shift),
                                  jax_swin._shift_attn_mask(h, h, ws, shift))


def test_window_partition_and_reverse_exact(rng):
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    got = swinv2.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_swin.window_partition(x, 4)))
    np.testing.assert_array_equal(swinv2.window_reverse(got, 4, 8, 8).numpy(), x)


@pytest.mark.parametrize("pd", [2, 4])
def test_ungroup_blocks_exact(rng, pd):
    x = rng.standard_normal((2, 3, 4, 5, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(ungroup_blocks(torch.from_numpy(x), pd).numpy(),
                                  np.asarray(jax_ungroup(jnp.asarray(x), pd)))


def test_patch4_embedding_matches_jax(rng):
    y = (rng.standard_normal((2, 1, 8, 8, 8, 8)) * 50).astype(np.float32)
    c = (rng.standard_normal((2, 2, 4, 4, 8, 8)) * 50).astype(np.float32)
    jax_embed = JaxPatchEmbed(patch_size=4, emb_size=32, add_sincos=False, use_norm=True)
    params = jax_embed.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(c))["params"]
    params = perturb_norms(jax.tree.map(np.asarray, params), rng)
    want = np.asarray(jax_embed.apply({"params": params}, jnp.asarray(y), jnp.asarray(c)))
    embed = PatchEmbeddingDCTGroup(4, 32, add_sincos=False, use_norm=True)
    embed.load_state_dict(flax_to_state_dict(params))
    got = embed(torch.from_numpy(y), torch.from_numpy(c))
    assert got.shape == (2, 256, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


def test_drop_path_matches_jax_formula(rng):
    x = rng.standard_normal((6, 5, 4)).astype(np.float32)
    keep = np.array([True, False, True, True, False, True])
    rate = 0.2
    want = np.asarray(jnp.where(jnp.asarray(keep)[:, None, None], jnp.asarray(x) / (1.0 - rate),
                                0.0))
    drop = swinv2.DropPath(rate).train()
    got = drop(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert torch.equal(drop.eval()(torch.from_numpy(x), torch.from_numpy(keep)),
                       torch.from_numpy(x))
    assert torch.equal(swinv2.DropPath(0.0).train()(torch.from_numpy(x)), torch.from_numpy(x))
    with pytest.raises(ValueError, match="keep mask"):
        drop.train()(torch.from_numpy(x))


@pytest.fixture(scope="module")
def jax_trainer():
    return jax_swin_trainer()


def test_logits_match_jax(jax_trainer, rng):
    """Through every branch: shifted and unshifted windows, the clamp to one
    window at stage 3, patch merging, the CPB-MLP and the head."""
    cfg = tiny_swin_cfg(generate_config)
    model = port_swin_trainer(jax_trainer, cfg).model.eval()
    assert [(b.window_size, b.shift_size) for b in model.blocks()] == [
        (4, 0), (4, 2), (4, 0), (4, 2), (4, 0), (4, 0)]
    y = rng.uniform(-1, 1, (3, 1, 8, 8, 8, 8)).astype(np.float32)
    c = rng.uniform(-1, 1, (3, 2, 4, 4, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jax_trainer.model.apply)({"params": jax_trainer.state.params},
                                                       jnp.asarray(y), jnp.asarray(c)))
    with torch.inference_mode():
        got = model(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert np.abs(want).max() > 0.1  # the logits are not all near zero


def test_logits_match_jax_at_window16(rng):
    """The parity case at SwinV2-B/w16's window: 256-token windows, shifted
    and unshifted, the clamp to one 256-token window, then 64 and 16."""
    jax_w16 = jax_swin_trainer(window16=True)
    model = port_swin_trainer(jax_w16, tiny_swin_cfg(generate_config, window16=True)).model
    model = model.eval()
    assert [(b.window_size, b.shift_size) for b in model.blocks()] == [
        (16, 0), (16, 8), (16, 0), (16, 0), (8, 0), (8, 0), (4, 0), (4, 0)]
    y = rng.uniform(-1, 1, (2, 1, 16, 16, 8, 8)).astype(np.float32)
    c = rng.uniform(-1, 1, (2, 2, 8, 8, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jax_w16.model.apply)({"params": jax_w16.state.params},
                                                   jnp.asarray(y), jnp.asarray(c)))
    with torch.inference_mode():
        got = model(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert np.abs(want).max() > 0.1


def test_decay_mask_matches_kernel_mask(jax_trainer):
    """Every flax ``kernel`` / ``qkv_kernel`` leaf maps to a parameter that
    decays; every ``scale``, ``bias``, ``logit_scale``, ``q_bias`` and
    ``v_bias`` to one that does not."""
    params = jax.tree.map(np.asarray, jax_trainer.state.params)
    flat_mask = {"/".join(str(k.key) for k in path): bool(v)
                 for path, v in jax.tree_util.tree_leaves_with_path(kernel_mask(params))}
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
    model = build_model(tiny_swin_cfg(generate_config), device="cpu")
    assert decay_parameter_names(model) == want
    assert {"layer0_block0.attn.qkv.weight", "layer0_block0.attn.cpb_mlp1.weight",
            "layer0_block0.attn.cpb_mlp2.weight"} <= want
    assert set(dict(model.named_parameters())) == set(flax_to_state_dict(params))


def test_trainer_evaluate_matches_jax(jax_trainer):
    """The K=48 eval wire at 8 blocks, from rows the smoke script writes."""
    jt = jax_trainer
    cfg = tiny_swin_cfg(generate_config)
    y, c = chip_smoke.synthetic_planes(np.random.default_rng(1), 6, cfg.model.dct_blocks)
    rows = chip_smoke.write_rows(y, c, np.arange(6, dtype=np.int32) % 10, 48)
    batches = [{"packed": rows[:4]}, {"packed": rows[4:]}]
    want = jt.evaluate(batches)
    got = port_swin_trainer(jt, cfg).evaluate(batches)
    assert got["count"] == want["count"] == 6
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight JPEGs of several sizes, so the whole-image resize both shrinks
    and enlarges."""
    root = tmp_path_factory.mktemp("swin_corpus")
    rng = np.random.default_rng(0)
    lines = ["Filepath,Label"]
    for i, (h, w) in enumerate([(64, 64), (96, 80), (128, 128), (40, 72), (64, 64),
                                (200, 136), (48, 48), (80, 112)]):
        ys, xs = np.mgrid[0:h, 0:w]
        img = np.stack([(128 + 80 * np.sin(ys / (3 + i + ch)) * np.cos(xs / 4)
                         + 10 * rng.standard_normal((h, w))).clip(0, 255).astype(np.uint8)
                        for ch in range(3)])
        path = root / f"i{i}.jpg"
        jax_codec.write_tensor(path, img, quality=92)
        lines.append(f"{path},{i % 3}")
    index = root / "index.csv"
    index.write_text("\n".join(lines) + "\n")
    return index


def test_make_loaders_eval_by_whole_image_resize(corpus):
    loaders = make_loaders(tiny_swin_cfg(generate_config), corpus, corpus, num_threads=2)
    assert loaders["train"].mode == "train" and loaders["train"].k == 16
    for split in ("minival", "trainval", "test"):
        assert (loaders[split].mode, loaders[split].k, loaders[split].target) == ("full", 48, 8)


def test_evaluate_model_matches_jax(jax_trainer, corpus, tmp_path):
    jt = jax_trainer
    cfg_jax = tiny_swin_cfg(jax_generate_config)
    loaders = jax_make_loaders(cfg_jax, corpus, corpus, global_batch=4, transfer="cropped",
                               packed_k_eval=jt.packed_k_eval, eval_fmt=jt.eval_fmt,
                               num_threads=2)
    want = jt.evaluate(loaders["test"])
    weights = tmp_path / "swin.pt"
    torch.save(flax_to_state_dict(jax.tree.map(np.asarray, jt.state.params)), weights)
    got = evaluate_model(tiny_swin_cfg(generate_config), corpus, corpus, str(weights),
                         device="cpu", num_threads=2)["test"]
    assert got["count"] == want["count"] == 8
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
