"""The RGB domain of the port against the JAX package's, on the CPU.

- ``RgbCroppedLoader`` rows byte-identical to the JAX loader's in each crop
  mode, ``RgbCanvasLoader``'s canvases identical, ``packed_layout(geom=
  True)`` the JAX layout.
- The RGB cropped train and eval pipelines on those rows: the decoded
  window exactly, the resampled eval output at 1e-5 of the [-1, 1] range
  (the resample's products summed in another order), the train output with
  JAX's flip and policy handed over, per pixel (a rounding-level difference
  may cross a later round's threshold): all but 1% within 1e-5.
- The RGB ViT and SwinV2 (its convolution stem and patch norm) from
  converted flax parameters: logits at ``test_torch_port_model.py``'s atol
  1e-5, rtol 1e-4.
- A 3-step lockstep of the RGB ViT ``Trainer`` against the JAX ``Trainer``
  at depth 2, emb 48, batch 4, 64 px, at ``test_torch_port_train.py``'s
  ``LOSS_RTOL`` and ``PARAM_ATOL``.
- The full-canvas RGB transfers (packed and dense): one Trainer step each.
- ``benchmark_model_synthetic`` in training mode with drop path (SwinV2 at
  its preset's 0.2) and dropout (ViT at 0.1): positive img/s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.augment import pipeline as jpipe
from rgbnomore_tpu.data.index import load_index as jax_load_index
from rgbnomore_tpu.data.loader import RgbCanvasLoader as JaxCanvasLoader
from rgbnomore_tpu.data.loader import RgbCroppedLoader as JaxCroppedLoader
from rgbnomore_tpu.data.loader import packed_layout as jax_layout
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.train.loop import Trainer as JaxTrainer
from rgbnomore_tpu_torch import benchmark
from rgbnomore_tpu_torch.augment import pipeline
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.data.loader import RgbCanvasLoader, RgbCroppedLoader, packed_layout
from rgbnomore_tpu_torch.train.config import build_model, generate_config
from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders
from rgbnomore_tpu_torch.train.optim import warmup_cosine_schedule
from test_torch_port_train import LOSS_RTOL, PARAM_ATOL, _key_bias_entries
from torch_port_support import (
    jax_rgb_policy,
    jax_step_draws,
    perturb_norms,
    settle_inspect_module_walk,
    tiny_swin_cfg,
    torch_threads,
    write_corpus,
)

SIZE = 64  # the tests' input size: an 8-block window, 4x4 patches of 16 px
BATCH = 4
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)
RANGE_TOL = 1e-5  # on [-1, 1]: 1e-3 of a gray level


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(write_corpus(tmp_path_factory.mktemp("rgb"), n=8, size=96))


def _tiny_vit_cfg(gen):
    cfg = gen("vitti", "rgb", batchsize=BATCH, epochs=1, warmup_steps=2, seed=5)
    cfg.model.depth, cfg.model.embed_size, cfg.model.heads = 2, 48, 2
    cfg.model.head_size, cfg.model.classes, cfg.model.input_size = 24, 10, SIZE
    return cfg


def test_layout_with_geom_matches_jax():
    assert dict(packed_layout(28, 63, "mask16", geom=True)) == jax_layout(28, 63, "mask16",
                                                                          geom=True)


@pytest.mark.parametrize("mode", ["train", "center", "full"])
def test_cropped_rows_byte_identical(corpus, mode):
    kw = dict(size=SIZE, mode=mode, seed=3, shuffle=mode == "train", num_threads=2)
    got = next(iter(RgbCroppedLoader(load_index(corpus), BATCH, **kw)))
    want = next(iter(JaxCroppedLoader(jax_load_index(corpus), BATCH, **kw)))
    for key in ("packed", "labels", "weights"):
        np.testing.assert_array_equal(got[key], want[key])


def test_canvas_rows_identical(corpus):
    got = next(iter(RgbCanvasLoader(load_index(corpus), BATCH, image_size=128, num_threads=2)))
    want = next(iter(JaxCanvasLoader(jax_load_index(corpus), BATCH, image_size=128)))
    for key in ("pixels", "labels", "weights"):
        np.testing.assert_array_equal(got[key], want[key])


def _rows(corpus, mode):
    ldr = RgbCroppedLoader(load_index(corpus), BATCH, size=SIZE, mode=mode, seed=3,
                           num_threads=2)
    return next(iter(ldr))["packed"]


def test_cropped_eval_pipeline_matches_jax(corpus):
    rows = _rows(corpus, "center")
    pixels, _, _, _ = pipeline.RgbCroppedTrainPipeline(SIZE, 63, [], 2, 10).decode(
        torch.from_numpy(rows))
    f = jpipe.split_packed_batch(jnp.asarray(rows), SIZE // 8, 63, "mask16", geom=True)
    from rgbnomore_tpu.ops.pixel_decode import decode_rgb_pixels

    np.testing.assert_array_equal(pixels.numpy(),
                                  np.asarray(decode_rgb_pixels(*jpipe.unpack_fields(f, "mask16"))))
    got = pipeline.make_rgb_cropped_eval_pipeline(size=SIZE)(torch.from_numpy(rows))
    want = jpipe.make_rgb_cropped_eval_pipeline(size=SIZE)(jnp.asarray(rows))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=RANGE_TOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cropped_train_pipeline_matches_jax(corpus):
    from rgbnomore_tpu.augment.rgb import RandAugmentRGB as JaxRandAugmentRGB
    from rgbnomore_tpu.train.config import AUGLIST_RGB

    rows = _rows(corpus, "train")
    key = jax.random.PRNGKey(4)
    want = jpipe.make_rgb_cropped_train_pipeline(size=SIZE, auglist=list(AUGLIST_RGB))(
        key, jnp.asarray(rows))
    k_flip, k_aug = jax.random.split(key)
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (BATCH,))))
    jaug = JaxRandAugmentRGB(ops_list=list(AUGLIST_RGB), image_hw=(SIZE, SIZE), fill=128.0)
    policy = tuple(torch.from_numpy(p) for p in jax_rgb_policy(jaug, k_aug, BATCH))
    pipe = pipeline.make_rgb_cropped_train_pipeline(size=SIZE, auglist=list(AUGLIST_RGB))
    got = pipe(torch.from_numpy(rows), flip, policy)
    off = np.abs(got[0].numpy() - np.asarray(want[0])) > RANGE_TOL
    assert off.mean() <= 1e-2, f"{off.mean():.2e} of pixels apart"
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _flax_params(jcfg, inputs, seed=0):
    model = jax_build_model(jcfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), *inputs)
    return model, jax.tree.map(np.asarray, variables["params"])


def test_rgb_vit_logits_match_flax(rng):
    x = rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32)
    jmodel, params = _flax_params(_tiny_vit_cfg(jax_generate_config), (jnp.asarray(x),))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = build_model(_tiny_vit_cfg(generate_config), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    assert tuple(model.patchembed.projection.weight.shape) == (48, 3, 16, 16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def _tiny_swin_rgb(gen, drop_path=0.0):
    """``tiny_swin_cfg``'s SwinV2 in the RGB domain cut to its first stage
    (an unshifted and a shifted block, then the norm and head), float32: 64
    px at patch 4 make its 16x16 tokens."""
    cfg = gen("swinv2", "rgb", batchsize=BATCH, epochs=1, warmup_steps=2, seed=5)
    small = tiny_swin_cfg(gen)
    for name in ("embed_size", "window_size", "classes"):
        setattr(cfg.model, name, getattr(small.model, name))
    cfg.model.depth, cfg.model.heads, cfg.model.pretrained_window_sizes = (2,), (2,), (0,)
    cfg.model.input_size, cfg.model.drop_path, cfg.train.amp = SIZE, drop_path, False
    return cfg


def test_rgb_swin_logits_match_flax(rng):
    x = rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32)
    jmodel, params = _flax_params(_tiny_swin_rgb(jax_generate_config), (jnp.asarray(x),))
    params = perturb_norms(params, np.random.default_rng(3))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = build_model(_tiny_swin_rgb(generate_config), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    assert tuple(model.patch_embed.weight.shape) == (32, 3, 4, 4)
    assert model.patch_norm is not None
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.fixture(scope="module")
def jax_rgb_trainer():
    trainer = JaxTrainer(_tiny_vit_cfg(jax_generate_config), devices=jax.devices()[:1],
                         transfer="cropped")
    trainer.create_state(steps_per_epoch=10)
    return trainer


def test_rgb_trainer_lockstep_with_jax(jax_rgb_trainer, corpus):
    jt = jax_rgb_trainer
    cfg = _tiny_vit_cfg(generate_config)
    rows = _rows(corpus, "train")
    trainer = Trainer(cfg, device="cpu")
    assert trainer.packed_k == jt.packed_k == 63
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                                  jt.state.params)))
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    step_fn = jt._fused_train_step()
    base_rng = jax.random.PRNGKey(cfg.seed + 1)
    schedule = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup, 10)
    state = jax.tree.map(jnp.copy, jt.state)  # the step donates its state
    for step in range(3):
        draws = jax_step_draws(jt, base_rng, step, BATCH, None)
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
            np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} step {step}")
    jt.state = state
    res = trainer.evaluate([{"packed": _rows(corpus, "center")}])
    want = jt.evaluate([{"packed": _rows(corpus, "center")}])
    assert res["count"] == want["count"] == BATCH
    np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_full_canvas_rgb_transfers_step(corpus, transfer):
    cfg = _tiny_vit_cfg(generate_config)
    trainer = Trainer(cfg, device="cpu", transfer=transfer, canvas=128)
    loaders = make_loaders(cfg, corpus, corpus, num_threads=2, transfer=transfer, canvas=128)
    batch = next(iter(loaders["train"]))
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=2)
    loss = float(trainer.train_step(trainer.upload(batch)))
    res = trainer.evaluate([next(iter(loaders["test"]))])
    assert np.isfinite(loss) and res["count"] == BATCH and np.isfinite(res["loss"])
    with pytest.raises(ValueError, match="only in the DCT domain"):
        Trainer(cfg, device="cpu", transfer=transfer, packed_k_eval=48)


@pytest.mark.parametrize("case", ["swin_drop_path", "vit_dropout"])
def test_benchmark_trains_with_drop(case):
    """``--benchmark``'s fwd+bwd step in training mode with SwinV2's drop
    path at its preset's rate and with ViT dropout, where it raised for
    want of the masks."""
    if case == "swin_drop_path":  # the blocks' rates 0 and 0.2
        cfg = _tiny_swin_rgb(generate_config, drop_path=0.2)
        cfg.train.batch_size = 2
        assert generate_config("swinv2", "dct").model.drop_path == 0.2
    else:
        cfg = generate_config("vitti", "dct", modelver=1, batchsize=2, drop=0.1)
        cfg.model.depth, cfg.model.classes = 1, 4
        cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    settle_inspect_module_walk()
    n, dt = benchmark.benchmark_model_synthetic(cfg, 1, "fbp", n_devices=1, device="cpu")
    assert n == 2 * 300 and n / dt > 0
