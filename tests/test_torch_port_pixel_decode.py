"""The port's JPEG tail decode, codec wrappers and pixel oracles against the
JAX package's, on the CPU.

- ``idct_plane``, ``fancy_upsample_2x``, ``ycbcr_to_rgb_pixels`` and
  ``decode_rgb_pixels`` exactly against the JAX decode, on the coefficients
  of real JPEGs; against a host libjpeg decode (``read_jpeg``) within
  ``tests/test_pixel_decode.py``'s limits (max 3 levels, mean 0.15, at most
  2% of pixels more than 1 apart).
- ``make_packed_rgb_decode`` on ``DctPackedLoader``'s K=63 mask16 rows,
  exactly against JAX's.
- The codec wrappers (``read_coefficients``, ``write_coefficients``,
  ``quantize_at_quality``, ``decode_coeff``, ``read_jpeg``) against the JAX
  package's codec, and the oracles ``rgb_to_dct`` / ``ycbcr_to_rgb``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu import codec as jcodec
from rgbnomore_tpu.augment import convert as jconvert
from rgbnomore_tpu.augment.pipeline import make_packed_rgb_decode as jax_packed_decode
from rgbnomore_tpu.ops import pixel_decode as jpd
from rgbnomore_tpu_torch import codec
from rgbnomore_tpu_torch.augment import convert
from rgbnomore_tpu_torch.augment.pipeline import make_packed_rgb_decode
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.data.loader import DctPackedLoader
from rgbnomore_tpu_torch.ops import pixel_decode as pd


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """Three 128x128 colour JPEGs of varying frequency content (the JAX
    test's) and a grayscale one, written by the port's codec, with their
    index."""
    root = tmp_path_factory.mktemp("port_pdec")
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:128, 0:128]
    imgs = [
        np.stack([(128 + 90 * np.sin(ys / 7 + p) * np.cos(xs / 5)).astype(np.uint8)
                  for p in (0, 1, 2)]),
        rng.integers(0, 255, (3, 128, 128)).astype(np.uint8),
        np.clip(np.stack([ys + xs, ys * 2, xs * 2]) % 256
                + rng.normal(0, 8, (3, 128, 128)), 0, 255).astype(np.uint8),
        (64 + ys // 2).astype(np.uint8)[None],
    ]
    paths, rows = [], ["Filepath,Label"]
    for i, img in enumerate(imgs):
        p = root / f"img_{i}.jpg"
        codec.write_tensor(p, img, quality=88)
        paths.append(str(p))
        rows.append(f"{p},{i}")
    (root / "index.csv").write_text("\n".join(rows) + "\n")
    return paths, str(root / "index.csv")


def _dequantized(path):
    """(y (1, 1, H, W, 8, 8), c (1, 2, ...)) float32 dequantized
    coefficients of a colour JPEG, from the port's codec."""
    _, quant, y, c = codec.read_coefficients(path)
    y = (y * quant[0]).astype(np.float32)[None]
    c = (c * quant[1:3, None, None]).astype(np.float32)[None]
    return y, c


def test_stages_match_jax_exactly(photos):
    for path in photos[0][:3]:
        y, c = _dequantized(path)
        got = pd.idct_plane(torch.from_numpy(c[:, 0]))
        want = jpd.idct_plane(jnp.asarray(c[:, 0]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(pd.fancy_upsample_2x(got).numpy(),
                                      np.asarray(jpd.fancy_upsample_2x(want)))
        planes = [np.random.default_rng(1).integers(0, 256, (2, 16, 16)).astype(np.float32)
                  for _ in range(3)]
        np.testing.assert_array_equal(
            pd.ycbcr_to_rgb_pixels(*map(torch.from_numpy, planes)).numpy(),
            np.asarray(jpd.ycbcr_to_rgb_pixels(*map(jnp.asarray, planes))))
        np.testing.assert_array_equal(
            pd.decode_rgb_pixels(torch.from_numpy(y), torch.from_numpy(c)).numpy(),
            np.asarray(jpd.decode_rgb_pixels(jnp.asarray(y), jnp.asarray(c))))


def test_decode_matches_libjpeg(photos):
    """tests/test_pixel_decode.py's limits on the port's decode."""
    for path in photos[0][:3]:
        y, c = _dequantized(path)
        got = pd.decode_rgb_pixels(torch.from_numpy(y), torch.from_numpy(c))[0].numpy()
        ref = codec.read_jpeg(path).astype(np.float32)
        diff = np.abs(got - ref)
        assert diff.max() <= 3.0 and diff.mean() <= 0.15 and (diff > 1).mean() <= 0.02


def test_packed_rgb_decode_matches_jax(photos):
    _, index = photos
    rows = next(iter(DctPackedLoader(load_index(index), 4, canvas=16, k=63, fmt="mask16")))
    got = make_packed_rgb_decode(16, 63, "mask16")(torch.from_numpy(rows["packed"]))
    want = jax_packed_decode(16, 63, "mask16")(jnp.asarray(rows["packed"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gray = got[0][3].numpy()  # the grayscale file decodes to neutral chroma
    np.testing.assert_array_equal(gray[0], gray[1])
    np.testing.assert_array_equal(gray[1], gray[2])


def test_codec_wrappers_match_jax(photos, tmp_path):
    for path in photos[0]:
        for got, want in zip(codec.read_coefficients(path), jcodec.read_coefficients(path)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(codec.read_jpeg(path), jcodec.read_jpeg(path))
        dims, quant, y, c = codec.read_coefficients(path)
        np.testing.assert_array_equal(codec.decode_coeff(dims, quant, y, c),
                                      jcodec.decode_coeff(dims, quant, y, c))
        np.testing.assert_array_equal(codec.decode_coeff(dims, quant, y, c, quality=50),
                                      jcodec.decode_coeff(dims, quant, y, c, quality=50))
        out = tmp_path / "rewritten.jpg"
        codec.write_coefficients(out, dims, quant, y, c)
        for got, want in zip(codec.read_coefficients(out), (dims, quant, y, c)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    img = codec.read_jpeg(photos[0][0])
    for got, want in zip(codec.quantize_at_quality(img, 75),
                         jcodec.quantize_at_quality(img, 75)):
        np.testing.assert_array_equal(got, want)


def test_pixel_oracles_match_jax(photos):
    img = codec.read_jpeg(photos[0][2])
    got, want = convert.rgb_to_dct(img), jconvert.rgb_to_dct(img)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    y, c = (a.astype(np.float32) * 2.0 for a in got)
    np.testing.assert_array_equal(convert.ycbcr_to_rgb(y, c), jconvert.ycbcr_to_rgb(y, c))
