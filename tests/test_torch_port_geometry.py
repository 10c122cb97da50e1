"""The port's block helpers, fast DCT and geometry against the JAX package's,
on the CPU, on the same seeded inputs.

Tolerances are the JAX package's own tests': the block products 1e-3
(``tests/test_ops_blocks.py``), the fast DCT 1e-4 (``test_ops_fastdct.py``;
1e-3 for its mirrored 2-D DFT), the DFT-route rotate and shear 1e-2
(``test_ops_geometry.py``).  The pixel resampler is exact: the sample
coordinates are computed in float32 from the same Python floats in the same
order, so every sample, ties included, lands on the same pixel.
"""

import numpy as np
import pytest
import torch

from rgbnomore_tpu.ops import blocks as jb
from rgbnomore_tpu.ops import fastdct as jf
from rgbnomore_tpu.ops import geometry as jg
from rgbnomore_tpu_torch.ops import blocks as tb
from rgbnomore_tpu_torch.ops import fastdct as tf
from rgbnomore_tpu_torch.ops import geometry as tg

PAD = 2**0.5


def _coeffs(rng, shape=(2, 1, 6, 6, 8, 8), scale=50.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("name,args,atol", [
    ("combine_blocks", (), 1e-3),
    ("blockshift", ((-4, -3),), 0),
    ("iblockshift", ((-4, -3),), 0),
    ("upsample_dct", (2, 3), 1e-3),
    ("downsample_dct", (2, 3), 1e-3),
    ("resize_dct", (4,), 1e-3),
    ("resize_dct", (9,), 1e-3),
    ("crop_dct", (-1, 2, 5, 6), 0),
    ("crop_dct", (1, 1, 4, 4), 0),
    ("combine_blocks_dft", (), 1e-2),
], ids=["combine", "blockshift", "iblockshift", "upsample", "downsample", "resize_down",
        "resize_up", "crop_padded", "crop_plain", "combine_dft"])
def test_block_helpers_match_jax(rng, name, args, atol):
    x = _coeffs(rng)
    _close(getattr(tb, name)(torch.from_numpy(x), *args), getattr(jb, name)(x, *args), atol)


def test_decompose_roundtrips_match_jax(rng):
    x = _coeffs(rng, (3, 6, 6, 8, 8))
    flat = np.array(jb.combine_blocks(x))
    _close(tb.decompose_blocks(torch.from_numpy(flat), 6, 6), jb.decompose_blocks(flat, 6, 6),
           1e-3)
    dft = np.array(jb.combine_blocks_dft(x))
    got = tb.decompose_blocks_dft(torch.from_numpy(dft), 6, 6)
    _close(got, jb.decompose_blocks_dft(dft, 6, 6), 1e-3)
    _close(got, x, 1e-3)  # the round trip itself


_FAST = ["fct_1d", "ifct_1d", "fct_2d", "ifct_2d", "dct2dft_fast_1d", "dct2dft_fast_2d",
         "dft2dct_1d", "dft2dct_2d", "dct2dft_2n_1d", "phase_shift_dft_1d",
         "phase_shift_dft_2d"]


@pytest.mark.parametrize("name", _FAST)
def test_fastdct_matches_jax(rng, name):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    _close(getattr(tf, name)(torch.from_numpy(x)), getattr(jf, name)(x), 1e-4)


def test_fastdct_mirrored_2d_matches_jax(rng):
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    dft = np.array(jf.dct2dft_2n_2d(x))
    _close(tf.dct2dft_2n_2d(torch.from_numpy(x)), dft, 1e-3)
    _close(tf.dft2dct_2n_2d(torch.from_numpy(dft)), jf.dft2dct_2n_2d(dft), 1e-4)
    _close(tf.dft2dct_2n_1d(torch.from_numpy(dft)), jf.dft2dct_2n_1d(dft), 1e-4)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("deg", [30.0, -30.0, 90.0, 45.0, 17.3, -180.0])
def test_rotate_image_matches_jax_exactly(rng, deg, interp):
    img = (rng.random((2, 3, 31, 40)) * 255).astype(np.float32)
    got = tg.rotate_image(torch.from_numpy(img), deg, interp, fill=128.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.rotate_image(img, deg, interp, 128.0)))


@pytest.mark.parametrize("deg_x,deg_y", [(16.7, 0.0), (-16.7, 0.0), (0.0, 16.7), (0.0, -16.7),
                                         (5.0, -9.0)])
def test_shear_image_matches_jax_exactly(rng, deg_x, deg_y):
    img = (rng.random((2, 3, 32, 32)) * 255).astype(np.float32)
    got = tg.shear_image(torch.from_numpy(img), deg_x, deg_y, fill=128.0)
    want = jg.shear_image(img, deg_x, deg_y, fill=128.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inverse_affine_matrix_matches_jax():
    for args in [(30.0,), (-12.5, (1.0, 2.0), 1.1, (3.0, -4.0), (7.5, 9.5))]:
        assert tg.inverse_affine_matrix(*args) == jg.inverse_affine_matrix(*args)


@pytest.mark.parametrize("deg", [10.0, -10.0, 30.0, 95.0, -200.0])
def test_rotate_block_matches_jax(rng, deg):
    x = _coeffs(rng)
    _close(tg.rotate_block(torch.from_numpy(x), deg, pad=PAD), jg.rotate_block(x, deg, pad=PAD),
           1e-2)


@pytest.mark.parametrize("deg_x,deg_y", [(17.0, 0.0), (0.0, -17.0)])
def test_shear_block_matches_jax(rng, deg_x, deg_y):
    x = _coeffs(rng)
    got = tg.shear_block(torch.from_numpy(x), deg_x, deg_y, pad=PAD)
    _close(got, jg.shear_block(x, deg_x, deg_y, pad=PAD), 1e-2)


def test_windowed_rotate_matches_jax(rng):
    x = _coeffs(rng, (1, 2, 8, 8, 8, 8))
    _close(tg.rotate_block(torch.from_numpy(x), 20.0, window=True),
           jg.rotate_block(x, 20.0, window=True), 1e-2)


def test_rotate_block_90_is_near_exact(rng):
    """The JAX test's property on the port: a 90-degree rotation through the
    DFT route equals the exact block rotation."""
    x = torch.from_numpy(_coeffs(rng, (1, 8, 8, 8, 8)))
    _close(tg.rotate_block(x, 90.0), tb.rotate_dct_90deg(x, 1), 1e-2)

