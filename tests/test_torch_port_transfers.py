"""The port's packed and dense transfers against the JAX package's, on the CPU.

- ``packed_layout``'s ``mask`` and ``index`` formats, and the rows of
  ``DctPackedLoader`` in both (and mask16) and the canvases of
  ``DctCanvasLoader``, byte for byte against the JAX loaders on the same
  JPEGs; ``make_loaders(transfer=...)`` builds them.
- The random resized crop: the port's boxes are the reference's
  distribution (a candidate size, offsets inside the canvas, floored to the
  chroma scale), and with JAX's boxes handed over the crop is JAX's.
- ``make_train_pipeline`` / ``make_eval_pipeline`` (packed in both formats,
  and dense) against JAX's on the same rows, with JAX's crop boxes, flip
  and policy passed in, at the augmentation tolerance 2e-6; the index-format
  unpack against JAX's.
- A 2-step lockstep of ``Trainer(transfer="packed")`` with the JAX
  ``Trainer`` at the tolerances of ``test_torch_port_train.py``, and both
  transfers' ``Trainer.evaluate`` against JAX's.

Sizes: the 8-block ViT grid of ``test_torch_port_train.py`` (depth 2, emb
48, 2 heads of 24) on a 16-block canvas, 96-pixel JPEGs (12 x 12 blocks, so
that every image sits inside the canvas with room to crop around it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_support import settle_inspect_module_walk, torch_threads, write_corpus
from rgbnomore_tpu.augment import crops as jax_crops
from rgbnomore_tpu.augment import pipeline as jax_pipeline
from rgbnomore_tpu.augment.randaugment import RandAugmentDCT as JaxRandAugment
from rgbnomore_tpu.data import loader as jax_loader
from rgbnomore_tpu.data.index import load_index as jax_load_index
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.train.loop import Trainer as JaxTrainer
from rgbnomore_tpu.train.loop import make_loaders as jax_make_loaders
from rgbnomore_tpu_torch.augment import crops, pipeline
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.data import loader
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import StepDraws, Trainer, make_loaders
from rgbnomore_tpu_torch.train.optim import warmup_cosine_schedule

AUG_TOL = dict(atol=2e-6, rtol=0)  # tests/test_pallas_augpipe.py:75-76
CANVAS, GRID, BATCH = 16, 8, 4
# the lockstep's tolerances (tests/test_torch_port_train.py); a gradient
# entry is held to JAX's within GRAD_RTOL of the largest entry, the
# chip_smoke.py card-vs-CPU step's float32 rounding scale
LOSS_RTOL, PARAM_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(write_corpus(tmp_path_factory.mktemp("transfers"), n=12, size=96))


def _tiny_cfg(gen):
    cfg = gen("vitti", "dct", modelver=1, batchsize=BATCH, epochs=1, warmup_steps=2, seed=5)
    cfg.model.depth, cfg.model.embed_size, cfg.model.heads = 2, 48, 2
    cfg.model.head_size, cfg.model.classes, cfg.model.dct_blocks = 24, 10, GRID
    cfg.model.input_size = GRID * 8
    return cfg


def _first_batch(ldr):
    return next(iter(ldr))


@pytest.mark.parametrize("fmt", ["mask", "index", "mask16"])
@pytest.mark.parametrize("canvas,k", [(16, 16), (64, 16), (16, 48)])
def test_layout_matches_jax(fmt, canvas, k):
    assert loader.packed_layout(canvas, k, fmt) == jax_loader.packed_layout(canvas, k, fmt)


@pytest.mark.parametrize("fmt", ["mask", "index", "mask16"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["eval", "train"])
def test_packed_rows_byte_identical(corpus, fmt, shuffle):
    kw = dict(canvas=CANVAS, k=16, fmt=fmt, shuffle=shuffle, drop_last=shuffle, seed=3,
              num_threads=2)
    want = [b for b in jax_loader.DctPackedLoader(jax_load_index(corpus), BATCH, **kw)]
    got = [b for b in loader.DctPackedLoader(load_index(corpus), BATCH, **kw)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]["packed"].any()


def test_canvas_rows_byte_identical(corpus):
    kw = dict(canvas=CANVAS, shuffle=True, drop_last=True, seed=3, num_threads=2)
    want = [b for b in jax_loader.DctCanvasLoader(jax_load_index(corpus), 5, **kw)]
    got = [b for b in loader.DctCanvasLoader(load_index(corpus), 5, **kw)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]["y"][:, :, :12, :12].any() and not got[0]["y"][:, :, 12:].any()


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_make_loaders_matches_jax(corpus, transfer):
    cfg, cfg_jax = _tiny_cfg(generate_config), _tiny_cfg(jax_generate_config)
    cfg.train.split = cfg_jax.train.split = 0.25
    got = make_loaders(cfg, corpus, corpus, canvas=CANVAS, num_threads=2, transfer=transfer)
    want = jax_make_loaders(cfg_jax, corpus, corpus, canvas=CANVAS, num_threads=2,
                            transfer=transfer)
    cls = {"packed": loader.DctPackedLoader, "dense": loader.DctCanvasLoader}[transfer]
    for split in ("train", "minival", "trainval", "test"):
        assert type(got[split]) is cls and len(got[split]) == len(want[split])
    for g, w in zip(_first_batch(got["test"]).values(), _first_batch(want["test"]).values()):
        np.testing.assert_array_equal(g, w)


def _jax_boxes(rng, batch, target, canvas, scale=(0.05, 1.0), chroma_scale=2):
    """The boxes JAX's ``make_random_resized_crop`` draws from ``rng``
    (``crops.py:135-149``), as the port's ``(size_idx, i, j)``."""
    cands = jax_crops.crop_size_candidates(target, canvas)
    evens = jnp.asarray([c for c in cands if c <= target], jnp.int32)
    maxfac = int(evens.max())
    k_area, k_i, k_j = jax.random.split(rng, 3)
    area = canvas * canvas * jax.random.uniform(k_area, (batch,), minval=scale[0],
                                                 maxval=scale[1])
    side = jnp.round(jnp.sqrt(area))
    size = jnp.maximum(2, jax.vmap(
        lambda v: jax_crops._choose_closest(v, evens, maxfac, canvas))(side))
    i = jax.random.randint(k_i, (batch,), 0, canvas - size + 1) // chroma_scale * chroma_scale
    j = jax.random.randint(k_j, (batch,), 0, canvas - size + 1) // chroma_scale * chroma_scale
    size_idx = jnp.searchsorted(jnp.asarray(cands, jnp.int32), size)
    return tuple(torch.from_numpy(np.array(a, np.int64)) for a in (size_idx, i, j))


def _jax_pipeline_draws(rng, cfg, batch):
    """The crop boxes, flip bits and policy that JAX's ``make_train_pipeline``
    draws from ``rng`` (``pipeline.py:311-316``)."""
    k_crop, k_flip, k_aug = jax.random.split(rng, 3)
    boxes = _jax_boxes(k_crop, batch, cfg.model.dct_blocks, CANVAS)
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (batch,))))
    aug = JaxRandAugment(ops_list=list(cfg.train.auglist), num_ops=cfg.train.num_ops,
                         magnitude=cfg.train.augstr, grid=cfg.model.dct_blocks)
    grid = cfg.model.dct_blocks
    policy = tuple(torch.from_numpy(np.array(p)) for p in aug.draw_policy(k_aug, batch, grid,
                                                                            grid))
    return boxes, flip, policy


@pytest.mark.parametrize("target,canvas", [(8, 16), (28, 64), (32, 64)])
def test_crop_boxes_follow_the_reference_distribution(target, canvas):
    rrc = crops.make_random_resized_crop(target, canvas)
    gen = torch.Generator().manual_seed(0)
    size_idx, i, j = rrc.draw(gen, 4096)
    cands = torch.tensor(crops.crop_size_candidates(target, canvas))
    size = cands[size_idx]
    assert bool((size >= 2).all()) and bool((i % 2 == 0).all()) and bool((j % 2 == 0).all())
    assert bool((i + size <= canvas).all()) and bool((j + size <= canvas).all())
    # the JAX draw's sizes on as many samples: the same candidates, in like shares
    jsize = cands[_jax_boxes(jax.random.PRNGKey(0), 4096, target, canvas)[0]]
    for s in cands.tolist():
        assert abs(float((size == s).float().mean()) - float((jsize == s).float().mean())) < 0.04


@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop_matches_jax(rng, seed):
    y = rng.standard_normal((3, 1, CANVAS, CANVAS, 8, 8)).astype(np.float32)
    c = rng.standard_normal((3, 2, CANVAS // 2, CANVAS // 2, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_crops.make_random_resized_crop(GRID, CANVAS)(key, jnp.asarray(y), jnp.asarray(c))
    boxes = _jax_boxes(key, 3, GRID, CANVAS)
    got = crops.make_random_resized_crop(GRID, CANVAS).crop(torch.from_numpy(y),
                                                            torch.from_numpy(c), boxes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


def test_index_unpack_matches_jax(rng):
    vals = rng.integers(-127, 128, (2, 3, 3, 16)).astype(np.int8)
    idx = np.stack([rng.permutation(64)[:16] for _ in range(18)]).reshape(2, 3, 3, 16)
    idx = idx.astype(np.uint8)
    scales = rng.integers(1, 5, (2, 3, 3)).astype(np.uint8)
    want = jax_pipeline.unpack_coefficients(jnp.asarray(vals), jnp.asarray(idx),
                                            jnp.asarray(scales))
    got = pipeline.unpack_coefficients(*(torch.from_numpy(a) for a in (vals, idx, scales)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rows(corpus, fmt):
    ldr = jax_loader.DctPackedLoader(jax_load_index(corpus), BATCH, canvas=CANVAS, k=16, fmt=fmt,
                                     num_threads=2)
    return _first_batch(ldr)


@pytest.mark.parametrize("fmt", ["mask", "index", "dense"])
def test_train_pipeline_matches_jax(corpus, fmt):
    cfg, cfg_jax = _tiny_cfg(generate_config), _tiny_cfg(jax_generate_config)
    packed = fmt != "dense"
    wire = dict(canvas=CANVAS, packed=packed, packed_fmt=fmt if packed else "mask", packed_k=16)
    key = jax.random.PRNGKey(11)
    if packed:
        rows = _rows(corpus, fmt)["packed"]
        want = jax_pipeline.make_train_pipeline(cfg_jax, **wire)(key, jnp.asarray(rows))
        inputs = torch.from_numpy(rows)
    else:
        batch = _first_batch(jax_loader.DctCanvasLoader(jax_load_index(corpus), BATCH,
                                                        canvas=CANVAS, num_threads=2))
        want = jax_pipeline.make_train_pipeline(cfg_jax, **wire)(
            key, *(jnp.asarray(batch[n]) for n in ("y", "cbcr", "quant")))
        want = (*want, batch["labels"], batch["weights"])
        inputs = {n: torch.from_numpy(v) for n, v in batch.items()}
    boxes, flip, policy = _jax_pipeline_draws(key, cfg, BATCH)
    got = pipeline.make_train_pipeline(cfg, **wire)(inputs, flip, policy, boxes)
    assert got[0].shape == (BATCH, 1, GRID, GRID, 8, 8)
    assert got[1].shape == (BATCH, 2, GRID // 2, GRID // 2, 8, 8)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **AUG_TOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0].abs().max()) > 0.05  # the images reach the output


@pytest.mark.parametrize("arch", ["vit", "swin"])
@pytest.mark.parametrize("fmt", ["mask", "index", "dense"])
def test_eval_pipeline_matches_jax(corpus, fmt, arch):
    packed = fmt != "dense"
    wire = dict(canvas=CANVAS, packed=packed, packed_fmt=fmt if packed else "mask", packed_k=16,
                target=GRID, swin=arch == "swin")
    if packed:
        rows = _rows(corpus, fmt)["packed"]
        want = jax_pipeline.make_eval_pipeline(**wire)(jnp.asarray(rows))
        inputs = torch.from_numpy(rows)
    else:
        batch = _first_batch(jax_loader.DctCanvasLoader(jax_load_index(corpus), BATCH,
                                                        canvas=CANVAS, num_threads=2))
        want = jax_pipeline.make_eval_pipeline(**wire)(
            *(jnp.asarray(batch[n]) for n in ("y", "cbcr", "quant")))
        inputs = {n: torch.from_numpy(v) for n, v in batch.items()}
    got = pipeline.make_eval_pipeline(**wire)(inputs)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **AUG_TOL)
    assert got[2].tolist() == [0, 1, 2, 3] and got[3].tolist() == [1.0] * 4


def _jax_packed_step_draws(cfg, base_rng, step, batch):
    """The draws of the JAX Trainer's packed step ``step`` (``loop.py:
    247-257``, ``pipeline.py:311-316``) as the port's ``StepDraws``."""
    k_aug, k_mix, _ = jax.random.split(jax.random.fold_in(base_rng, step), 3)
    boxes, flip, policy = _jax_pipeline_draws(k_aug, cfg, batch)
    u = jax.random.beta(k_mix, cfg.train.mixup_alpha, cfg.train.mixup_alpha)
    return StepDraws(flip, policy, float(jnp.maximum(u, 1.0 - u)), crop=boxes)


@pytest.fixture(scope="module")
def jax_packed_trainer():
    trainer = JaxTrainer(_tiny_cfg(jax_generate_config), devices=jax.devices()[:1],
                         transfer="packed", canvas=CANVAS)
    trainer.create_state(steps_per_epoch=10)
    return trainer


def _port_trainer(jt, transfer):
    trainer = Trainer(_tiny_cfg(generate_config), device="cpu", transfer=transfer,
                      canvas=CANVAS)
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jt.state.params)))
    return trainer


def _jax_adam_mu(state) -> dict:
    """Adam's first moment of the JAX state, under the port's names."""
    return flax_to_state_dict(jax.tree.map(np.asarray,
                                           optax.tree_utils.tree_get(state.opt_state, "mu")))


def test_packed_trainer_lockstep_with_jax(jax_packed_trainer, corpus):
    jt = jax_packed_trainer
    cfg = _tiny_cfg(generate_config)
    rows = _rows(corpus, "mask")["packed"]
    trainer = _port_trainer(jt, "packed")
    assert (trainer.packed_fmt, trainer.packed_k) == (jt.packed_fmt, jt.packed_k) == ("mask", 16)
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    step_fn = jt._fused_train_step()
    base_rng = jax.random.PRNGKey(cfg.seed + 1)
    schedule = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup, 10)
    state = jax.tree.map(jnp.copy, jt.state)  # the step donates its state
    inner = cfg.model.heads * cfg.model.head_size
    b1 = trainer.optimizer.opt.defaults["betas"][0]
    # Entries whose gradient is at rounding level: the key third of each qkv
    # bias (zero in exact arithmetic, as in test_torch_port_train.py), and
    # entries whose gradient falls below 10x Adam's eps at some step in both
    # packages (here the crop's products round in another order than XLA's,
    # so such a gradient is mostly noise, which Adam's first steps turn into
    # moves of up to the learning rate).  JAX's clipped gradient of a step is
    # read from its Adam state, mu_t = b1 mu_{t-1} + (1 - b1) g_t, and the
    # port's after its step's clip.  Every entry's gradient is held to JAX's
    # within GRAD_RTOL of the largest entry, the masked ones too; the masked
    # entries' parameters are held to the sum of the learning rates, what the
    # steps can move a parameter at most, and every other entry's to
    # PARAM_ATOL.
    noisy = {name: np.zeros(p.shape, bool) for name, p in trainer.model.named_parameters()}
    for name in noisy:
        if name.endswith("mha.qkv.bias"):
            noisy[name][inner:2 * inner] = True
    mu_prev = {name: 0.0 for name in noisy}
    for step in range(2):
        draws = _jax_packed_step_draws(cfg, base_rng, step, BATCH)
        state, metrics = step_fn(state, jt.put_batch({"packed": rows}), base_rng)
        loss = trainer.compute_grads(torch.from_numpy(rows), draws)
        trainer.optimizer.step()
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
        mu = {name: m.numpy() for name, m in _jax_adam_mu(state).items()}
        grad_jax = {name: (mu[name] - b1 * mu_prev[name]) / (1 - b1) for name in noisy}
        mu_prev = mu
        gmax = max(np.abs(g).max() for g in grad_jax.values())
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params))
        lr_sum = sum(schedule(s) for s in range(step + 1))
        for name, p in trainer.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grad_jax[name], atol=GRAD_RTOL * gmax,
                                       rtol=0, err_msg=f"gradient of {name} step {step}")
            noisy[name] |= ((np.abs(grad_jax[name]) < 10 * 1e-8)
                            & (np.abs(p.grad.numpy()) < 10 * 1e-8))
            got, ref, mask = p.detach().numpy(), want[name].numpy(), noisy[name]
            assert np.abs(got[mask] - ref[mask]).max(initial=0) <= lr_sum, name
            np.testing.assert_allclose(got[~mask], ref[~mask], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} step {step}")
    assert trainer.step == 2
    # 2.7% here, of the clipped gradients that Adam sees: most are
    # projection weights of the coefficients that the crop's resize
    # truncates (a constant input on every token)
    n_noisy = sum(m.sum() for m in noisy.values())
    assert n_noisy < 0.03 * sum(m.size for m in noisy.values()), n_noisy


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_trainer_evaluate_matches_jax(jax_packed_trainer, corpus, transfer):
    jt = jax_packed_trainer
    cfg_jax = _tiny_cfg(jax_generate_config)
    ref = JaxTrainer(cfg_jax, devices=jax.devices()[:1], transfer=transfer, canvas=CANVAS)
    ref.state = jt.state
    cls = {"packed": jax_loader.DctPackedLoader, "dense": jax_loader.DctCanvasLoader}[transfer]
    kw = dict(k=16, fmt="mask") if transfer == "packed" else {}
    batches = [b for b in cls(jax_load_index(corpus), BATCH, canvas=CANVAS, num_threads=2, **kw)]
    want = ref.evaluate(batches)
    got = _port_trainer(jt, transfer).evaluate(batches)
    assert got["count"] == want["count"] == 12
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_dense_trainer_steps_on_the_cpu(corpus):
    """The dense transfer's train step: the canvases uploaded as a dict,
    the draws made by the Trainer itself (boxes, flip, policy)."""
    trainer = Trainer(_tiny_cfg(generate_config), device="cpu", transfer="dense",
                      canvas=CANVAS)
    settle_inspect_module_walk()
    trainer.create_state(steps_per_epoch=10)
    batch = _first_batch(loader.DctCanvasLoader(load_index(corpus), BATCH, canvas=CANVAS,
                                                num_threads=2))
    draws = trainer.draw(BATCH)
    assert draws.crop is not None and all(t.shape == (BATCH,) for t in draws.crop)
    losses = [float(trainer.train_step(trainer.upload(batch))) for _ in range(2)]
    assert all(np.isfinite(losses)) and trainer.step == 2


def test_unknown_transfer_raises():
    with pytest.raises(ValueError, match="transfer must be one of"):
        Trainer(_tiny_cfg(generate_config), device="cpu", transfer="sparse")
    with pytest.raises(ValueError, match="mask, index or mask16"):
        loader.DctPackedLoader(None, 2, fmt="mask16q")


@pytest.mark.parametrize("transfer", ["packed", "dense"])
def test_full_canvas_transfers_refuse_cropped_settings(transfer):
    """The cropped wire's own settings are refused, not stored unused."""
    trainer = Trainer(_tiny_cfg(generate_config), device="cpu", transfer=transfer,
                      canvas=CANVAS)
    assert trainer.packed_k_eval is trainer.eval_fmt is trainer.train_fmt is None
    for kw in (dict(packed_k_eval=48), dict(eval_fmt="mask16"), dict(train_fmt="mask16")):
        with pytest.raises(ValueError, match="only transfer='cropped' takes them"):
            Trainer(_tiny_cfg(generate_config), device="cpu", transfer=transfer, **kw)
        with pytest.raises(ValueError, match="only transfer='cropped' takes them"):
            make_loaders(_tiny_cfg(generate_config), "unused", "unused", transfer=transfer,
                         **kw)


def test_crop_operators_reach_a_device_once():
    """The crop's stacked operators are copied to a device at its first
    batch there and reused (the meta device stands in for the card)."""
    rrc = crops.make_random_resized_crop(GRID, CANVAS)
    first = rrc._operators.on(torch.device("meta"))
    assert first[0].device.type == "meta" and rrc._operators.on("meta")[0] is first[0]
    assert rrc._operators.on("cpu")[0].device.type == "cpu"

