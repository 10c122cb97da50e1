"""The port's RGB augmentation against the JAX package's, on the CPU.

- ``resample_matrix``, the eval transform and ``RandomResizedCropRGB``'s
  boxes and crop, from JAX's draws: the matrices at 1e-6 (each row's sum is
  taken in another order), the resampled pixels at 1e-3 of a level.
- Each op of the big_vision table forced (a one-op list, two rounds), and
  ``RandAugmentRGB`` over ``AUGLIST_RGB``, with the draws JAX makes inside
  its ops re-derived from its keys (``torch_port_support.jax_rgb_policy``)
  and handed over.  The ops that sum products (Color, Contrast and
  Grayscale's luma, Sharpness's filter, ChromaDrop's and AutoSaturation's
  colour matrices) agree to 1e-3 of a level: XLA fuses their multiplies and
  adds, or sums in another order, a few float32 units at 255; every other
  op agrees exactly.  Over the whole list a rounding-level difference
  can cross a threshold of a later round (Posterize, Solarize), so there
  the check is per pixel: all but 0.1% within 1e-3.
- The full-canvas train and eval pipelines (``make_rgb_train_pipeline``,
  ``make_rgb_eval_pipeline``) on JAX's draws, on the [-1, 1] output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.augment import rgb as jrgb
from rgbnomore_tpu.train.config import AUGLIST_RGB
from rgbnomore_tpu_torch.augment import rgb
from torch_port_support import jax_rgb_policy

EXACT_OPS = sorted(set(jrgb._rgb_magnitude_table(11, (32, 32)))
                   - {"Color", "Contrast", "Grayscale", "Sharpness", "ChromaDrop",
                      "AutoSaturation"})
LEVEL_TOL = 1e-3  # of a gray level, for products summed in another order


def _image(seed, b=6, size=32):
    """Pixels in [0, 255] with fractional parts (as after the resample) and
    some integer-valued rows (as after the decode)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, 3, size, size)).astype(np.float32)
    img[:, :, : size // 4] = np.round(img[:, :, : size // 4])
    return img


def _apply_both(ops, img, key, magnitude=10):
    size = img.shape[-1]
    jaug = jrgb.RandAugmentRGB(ops_list=ops, num_ops=2, magnitude=magnitude,
                               image_hw=(size, size), fill=128.0)
    want = np.asarray(jax.jit(jaug.__call__)(key, jnp.asarray(img)))
    policy = jax_rgb_policy(jaug, key, img.shape[0])
    aug = rgb.RandAugmentRGB(ops_list=ops, num_ops=2, magnitude=magnitude,
                             image_hw=(size, size), fill=128.0)
    got = aug.apply(torch.from_numpy(img), tuple(torch.from_numpy(p) for p in policy)).numpy()
    return got, want, policy


@pytest.mark.parametrize("name", sorted(jrgb._rgb_magnitude_table(11, (32, 32))))
def test_each_op_matches_jax(name):
    seed = sorted(jrgb._rgb_magnitude_table(11, (32, 32))).index(name)
    got, want, policy = _apply_both([name], _image(seed), jax.random.PRNGKey(seed))
    if name in EXACT_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=LEVEL_TOL, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_policy_draws_reach_both_signs_and_every_centre_row():
    aug = jrgb.RandAugmentRGB(ops_list=list(AUGLIST_RGB), image_hw=(32, 32))
    idx, sign, ch, cw, drop = jax_rgb_policy(aug, jax.random.PRNGKey(0), 256)
    assert set(np.unique(sign)) == {-1.0, 1.0} and drop.any() and not drop.all()
    assert ch.min() == 0 and ch.max() == 31 and len(np.unique(idx)) == len(AUGLIST_RGB)


def test_rand_augment_over_auglist_rgb_matches_jax():
    got, want, policy = _apply_both(list(AUGLIST_RGB), _image(40, b=32),
                                    jax.random.PRNGKey(11))
    assert len(np.unique(policy[0])) >= 12
    off = np.abs(got - want) > LEVEL_TOL
    assert off.mean() <= 1e-3, f"{off.mean():.2e} of pixels apart"


def test_resample_matrix_and_eval_transform_match_jax(rng):
    start = rng.uniform(0, 100, 5).astype(np.float32)
    size = rng.uniform(10, 300, 5).astype(np.float32)
    want = jax.vmap(lambda a, s: jrgb._resample_matrix(a, s, 320, 40))(start, size)
    got = rgb.resample_matrix(torch.from_numpy(start), torch.from_numpy(size), 320, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    img = rng.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        rgb.make_resize_center_crop_rgb(36, 32, 64)(torch.from_numpy(img)).numpy(),
        np.asarray(jrgb.make_resize_center_crop_rgb(36, 32, 64)(jnp.asarray(img))),
        atol=LEVEL_TOL, rtol=0)


def _jax_crop_draws(key, batch, canvas, tries=10):
    """The draws of the JAX ``make_random_resized_crop_rgb`` (``rgb.py:
    78-86``): the area share, the log aspect and the two corner uniforms."""
    k_area, k_ar, k_i, k_j = jax.random.split(key, 4)
    shape = (batch, tries)
    log_ratio = (np.log(3.0 / 4.0), np.log(4.0 / 3.0))
    return tuple(np.asarray(a) for a in (
        jax.random.uniform(k_area, shape, minval=0.05, maxval=1.0),
        jax.random.uniform(k_ar, shape, minval=log_ratio[0], maxval=log_ratio[1]),
        jax.random.uniform(k_i, shape), jax.random.uniform(k_j, shape)))


def _canvas(seed, b=4, canvas=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 3, canvas, canvas)).astype(np.uint8)


def test_train_pipeline_matches_jax():
    """``make_rgb_train_pipeline`` on pixel canvases with JAX's crop boxes,
    flip and policy (``rgb.py:408-417``)."""
    canvas, size, b = 64, 32, 6
    pixels = _canvas(3, b, canvas)
    key = jax.random.PRNGKey(5)
    jpipe = jrgb.make_rgb_train_pipeline(size=size, canvas=canvas, auglist=list(AUGLIST_RGB))
    want = np.asarray(jpipe(key, jnp.asarray(pixels)))
    k_crop, k_flip, k_aug = jax.random.split(key, 3)
    pipe = rgb.make_rgb_train_pipeline(size=size, canvas=canvas, auglist=list(AUGLIST_RGB))
    boxes = pipe.rrc.boxes(*(torch.from_numpy(d) for d in _jax_crop_draws(k_crop, b, canvas)))
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (b,))))
    jaug = jrgb.RandAugmentRGB(ops_list=list(AUGLIST_RGB), image_hw=(size, size), fill=128.0)
    policy = tuple(torch.from_numpy(p) for p in jax_rgb_policy(jaug, k_aug, b))
    got = pipe(torch.from_numpy(pixels), flip, policy, boxes).numpy()
    # the crop's products sum in another order (1e-3 of a level, 1e-5 of
    # the range); a later threshold may move a rare pixel further
    off = np.abs(got - want) > LEVEL_TOL / 127.5
    assert off.mean() <= 1e-2, f"{off.mean():.2e} of pixels apart"

    # the crop alone, exactly the same boxes
    jcrop = jrgb.make_random_resized_crop_rgb(size, canvas)(k_crop, jnp.asarray(pixels,
                                                                                jnp.float32))
    np.testing.assert_allclose(pipe.rrc.crop(torch.from_numpy(pixels).float(), boxes).numpy(),
                               np.asarray(jcrop), atol=LEVEL_TOL, rtol=0)


@pytest.mark.parametrize("arch", ["vits", "swinv2"])
def test_eval_pipeline_matches_jax(arch):
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config(arch, "rgb")
    pixels = _canvas(4, 2, 512)
    want = np.asarray(jrgb.make_rgb_eval_pipeline(cfg, canvas=512)(jnp.asarray(pixels)))
    got = rgb.make_rgb_eval_pipeline(cfg, canvas=512)(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (2, 3, cfg.model.input_size, cfg.model.input_size)
    np.testing.assert_allclose(got, want, atol=LEVEL_TOL / 127.5, rtol=0)
