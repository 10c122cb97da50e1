"""The port's eval path against the JAX package's, on the CPU.

- The port's ``DctCroppedLoader`` writes rows byte-identical to the JAX
  loader's for the same JPEGs, seed and mode.
- The port's ``make_cropped_eval_pipeline`` gives bit-exact y, c, labels and
  weights against JAX's on the same rows.
- ``Trainer.evaluate`` and ``evaluate_model`` give the JAX Trainer's eval
  sums with the same parameters: count and correct exactly, loss_sum to
  rtol 1e-5.
- ``make_loaders``'s train loader (K=16 mask16, random-resized-crop boxes,
  shuffled, the last partial batch dropped) writes the JAX one's rows.
- ``torch_port_support.write_rows``, which feeds the card check's slice, writes rows
  the port's pipeline unpacks to the planes it was given.
- ``codec.read_crop_resize_pack`` (the fields' own arrays) writes the JAX
  wrapper's bytes and returns its box, in each crop mode and wire format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import pack_mask16, write_rows
from rgbnomore_tpu import codec as jax_codec
from rgbnomore_tpu.augment.pipeline import make_cropped_eval_pipeline as jax_eval_pipeline
from rgbnomore_tpu.data import croppack as jax_croppack
from rgbnomore_tpu.data import loader as jax_loader
from rgbnomore_tpu.data.index import load_index as jax_load_index
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.train.loop import Trainer as JaxTrainer
from rgbnomore_tpu.train.loop import make_loaders as jax_make_loaders
from rgbnomore_tpu_torch import codec
from rgbnomore_tpu_torch.augment.pipeline import make_cropped_eval_pipeline
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.data import croppack, loader
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.eval import evaluate_model
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

# (height, width, gray): a small image, a non-square one, a large one
# (downsampled crop), a grayscale one (zero chroma) and an odd block grid
IMAGES = [(96, 96, False), (128, 200, False), (512, 512, False), (160, 160, True),
          (72, 104, False), (256, 192, False)]


def _write_jpeg(path, h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    f = 0.02 + 0.03 * rng.random(2)
    chans = 1 if gray else 3
    img = np.stack([(128 + 100 * np.sin(ys * f[0] + p) * np.cos(xs * f[1])
                     + 20 * rng.standard_normal((h, w))).clip(0, 255).astype(np.uint8)
                    for p in np.linspace(0, 2, chans)])
    jax_codec.write_tensor(path, img, quality=90)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = [_write_jpeg(root / f"img{i}.jpg", h, w, seed=i, gray=g)
             for i, (h, w, g) in enumerate(IMAGES)]
    index = root / "index.csv"
    index.write_text("Filepath,Label\n"
                     + "\n".join(f"{p},{i % 4}" for i, p in enumerate(paths)) + "\n")
    return index


def _batches(ldr):
    return [b for b in ldr]


@pytest.mark.parametrize("target", [8, 28])
@pytest.mark.parametrize("fmt", ["mask16", "mask16q", "mask16w"])
def test_layout_matches_jax(target, fmt):
    assert loader.packed_layout(target, 48, fmt) == jax_loader.packed_layout(target, 48, fmt)


@pytest.mark.parametrize("target", [8, 28])
@pytest.mark.parametrize("mode", ["center", "train"])
def test_loader_rows_byte_identical(corpus, target, mode):
    kw = dict(target=target, k=48, mode=mode, fmt="mask16", shuffle=mode == "train",
              seed=7, num_threads=2)
    want = _batches(jax_loader.DctCroppedLoader(jax_load_index(corpus), 4, **kw))
    got = _batches(loader.DctCroppedLoader(load_index(corpus), 4, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["packed"], w["packed"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["weights"], w["weights"])
    assert got[1]["weights"][2:].sum() == 0  # 6 images: the last 2 slots are padding


@pytest.mark.parametrize("fmt", ["mask16", "mask16q", "mask16w"])
def test_eval_pipeline_bit_exact(corpus, fmt):
    ldr = jax_loader.DctCroppedLoader(jax_load_index(corpus), 6, target=28, k=48,
                                      mode="center", fmt=fmt, num_threads=2)
    rows = next(iter(ldr))["packed"]
    want = jax_eval_pipeline(target=28, k=48, fmt=fmt)(jnp.asarray(rows))
    got = make_cropped_eval_pipeline(target=28, k=48, fmt=fmt)(torch.from_numpy(rows))
    for g, w, name in zip(got, want, ("y", "c", "labels", "weights")):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("mode", ["random", "center", "full"])
@pytest.mark.parametrize("fmt", ["mask16", "mask16w", "mask16q"])
def test_read_crop_resize_pack_matches_jax(corpus, mode, fmt):
    """Each corpus image into one row's field views, by both wrappers from
    the same draws: the same bytes and the same sampled box."""
    crop = {"random": codec.CROP_RANDOM, "center": codec.CROP_CENTER,
            "full": codec.CROP_FULL}[mode]
    layout = loader.packed_layout(28, 16, fmt)
    uniforms = np.random.default_rng(5).random((len(IMAGES), 12))
    kw = dict(ratio=28 / 32, wide=fmt == "mask16w", requant=fmt == "mask16q")
    for i, path in enumerate(load_index(corpus).paths):
        rows = []
        for mod, pack in ((codec, croppack.build_op_pack(28)),
                          (jax_codec, jax_croppack.build_op_pack(28))):
            row = np.zeros(layout["row"], np.uint8)
            v = loader.row_views(row, layout)
            box = mod.read_crop_resize_pack(path, 16, crop, uniforms[i], pack, v["vy"],
                                            v["iy"], v["sy"], v["dy"], v["vc"], v["ic"],
                                            v["sc"], v["dc"], v["quant"], **kw)
            rows.append((row, box))
        (got, got_box), (want, want_box) = rows
        assert got_box == want_box and got.any()
        np.testing.assert_array_equal(got, want)


def _eval_cfg(gen):
    cfg = gen("vitti", "dct", modelver=1)
    cfg.model.depth = 1
    cfg.model.classes = 4
    cfg.train.batch_size = 8
    return cfg


@pytest.fixture(scope="module")
def jax_eval(corpus):
    """The JAX Trainer's eval of the corpus and its parameters."""
    cfg = _eval_cfg(jax_generate_config)
    trainer = JaxTrainer(cfg, transfer="cropped")
    trainer.create_state(steps_per_epoch=1)
    loaders = jax_make_loaders(cfg, corpus, corpus, global_batch=trainer.global_batch(),
                               transfer="cropped", packed_k_eval=trainer.packed_k_eval,
                               eval_fmt=trainer.eval_fmt)
    params = jax.tree.map(np.asarray, trainer.state.params)
    return trainer.evaluate(loaders["test"]), params


def _assert_same_sums(got, want):
    assert got["count"] == want["count"] == len(IMAGES)
    assert got["accuracy"] * got["count"] == want["accuracy"] * want["count"]
    np.testing.assert_allclose(got["loss"] * got["count"], want["loss"] * want["count"],
                               rtol=1e-5)


def test_trainer_evaluate_matches_jax(corpus, jax_eval):
    want, params = jax_eval
    cfg = _eval_cfg(generate_config)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(params))
    loaders = make_loaders(cfg, corpus, corpus)
    _assert_same_sums(trainer.evaluate(loaders["test"]), want)


def test_train_loader_matches_jax(corpus):
    cfg_jax, cfg = _eval_cfg(jax_generate_config), _eval_cfg(generate_config)
    cfg_jax.train.batch_size = cfg.train.batch_size = 4
    want = jax_make_loaders(cfg_jax, corpus, corpus, global_batch=4, transfer="cropped",
                            num_threads=2)["train"]
    got = make_loaders(cfg, corpus, corpus, num_threads=2)["train"]
    assert (got.k, got.fmt, got.mode, got.shuffle, got.drop_last) == (
        16, "mask16", "train", True, True)
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        w_batches, g_batches = _batches(want), _batches(got)
        assert len(g_batches) == len(w_batches) == 1  # 6 images, batches of 4, drop_last
        np.testing.assert_array_equal(g_batches[0]["packed"], w_batches[0]["packed"])


def test_evaluate_model_matches_jax(corpus, jax_eval, tmp_path):
    want, params = jax_eval
    weights = tmp_path / "vitti.pt"
    torch.save(flax_to_state_dict(params), weights)
    res = evaluate_model(_eval_cfg(generate_config), corpus, corpus, str(weights),
                         device="cpu", num_threads=2)
    _assert_same_sums(res["test"], want)
    # 6 files: the 1% minival and 5% trainval splits are empty
    assert res["val"]["count"] == 1.0 and res["trainval"]["count"] == 1.0


def test_evaluate_model_refuses_missing_weights(corpus, tmp_path):
    with pytest.raises(FileNotFoundError):
        evaluate_model(_eval_cfg(generate_config), corpus, corpus,
                       str(tmp_path / "missing.pt"), device="cpu")


def test_guard_rejects_all_zero_weights():
    cfg = _eval_cfg(generate_config)
    trainer = Trainer(cfg, device="cpu")
    rows = np.zeros((2, loader.packed_layout(28, 48)["row"]), np.uint8)
    with pytest.raises(RuntimeError, match="no weighted examples"):
        trainer.evaluate([{"packed": rows}])


def test_smoke_rows_round_trip_exactly(rng):
    """Planes the wire holds exactly (integer ACs within int8, at most K of
    them per block) come back unchanged through the port's pipeline."""
    k, grid, n = 16, 8, 3
    y = np.zeros((n, 1, grid, grid, 8, 8), np.float32)
    c = np.zeros((n, 2, grid // 2, grid // 2, 8, 8), np.float32)
    for plane in (y, c):
        flat = plane.reshape(-1, 64)
        for blk in flat:
            pos = rng.choice(np.arange(1, 64), size=rng.integers(0, k + 1), replace=False)
            blk[pos] = rng.integers(-127, 128, size=len(pos))
            blk[0] = rng.integers(-1024, 1017)
    labels = np.array([3, 1, 2], np.int32)
    rows = write_rows(y, c, labels, k)
    gy, gc, gl, gw = make_cropped_eval_pipeline(target=grid, k=k)(torch.from_numpy(rows))
    to_range = lambda x: (x + 1024.0) / 2040.0 * 2.0 - 1.0  # noqa: E731
    np.testing.assert_allclose(gy.numpy(), to_range(y), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gc.numpy(), to_range(c), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gl.numpy(), labels)
    np.testing.assert_array_equal(gw.numpy(), np.ones(n, np.float32))


def test_smoke_pack_keeps_the_largest_acs(rng):
    """With more nonzero ACs than K, the packer keeps the K largest int8
    magnitudes, ties going to the lower position, as the C++ packer does."""
    k = 8
    blocks = (rng.standard_normal((200, 64)) * 300).astype(np.float32)
    vals, mask, scale, dc = pack_mask16(blocks, k)
    bits = np.unpackbits(mask, axis=-1, bitorder="little").astype(bool)
    for b in range(len(blocks)):
        s = scale[b]
        assert s == max(1, int(np.ceil(np.abs(blocks[b, 1:]).max() / np.float32(127))))
        inv = np.float32(1) / np.float32(s)
        q = np.minimum((np.abs(blocks[b, 1:]) * inv + np.float32(0.5)).astype(int), 127)
        want = sorted(range(63), key=lambda i: (-q[i], i))[:k]
        assert sorted(np.nonzero(bits[b, 1:])[0]) == sorted(want)
        assert not bits[b, 0] and dc[b] == np.rint(blocks[b, 0])
        kept = np.nonzero(bits[b])[0]
        np.testing.assert_array_equal(vals[b], np.sign(blocks[b, kept]) * q[kept - 1])
