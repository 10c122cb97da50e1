"""Arbitrary-angle rotate / shear of pixels and of DCT coefficients, and the
affine resampler they are built on (PyTorch).

Port of ``rgbnomore_tpu/ops/geometry.py``.  The reference routes these ops
through a global DFT and a torchvision ``rotate``/``affine`` on the real and
imaginary planes (``utils/dct_ops.py:367-434``, ``:957-1013``;
``utils/dct_torch_utils.py:232-321``).  The resampler is a gather whose
matrix follows torchvision's ``_get_inverse_affine_matrix``.

Angles are Python floats: in RandAugment only the sign of the magnitude is
random, so a batch runs each sign's branch on its own samples.  The sample
coordinates ``a * x + b * y + c`` are computed in float32 from the same
Python floats and in the same order as the JAX package computes them, so a
sample that falls exactly half-way between two pixels goes to the same one.
"""

from __future__ import annotations

import math

import torch

from rgbnomore_tpu_torch.ops.blocks import (
    blockshift,
    combine_blocks_dft,
    decompose_blocks_dft,
    iblockshift,
    rotate_dct_90deg,
)

__all__ = [
    "inverse_affine_matrix",
    "affine_resample",
    "rotate_image",
    "shear_image",
    "rotate_dft_2d_spatial",
    "shear_dft_2d_spatial",
    "rotate_block",
    "shear_block",
]


def inverse_affine_matrix(angle: float, translate=(0.0, 0.0), scale: float = 1.0,
                          shear=(0.0, 0.0), center=(0.0, 0.0)):
    """Inverse affine matrix mapping output pixel coordinates to input ones,
    in torchvision's convention (angle in degrees counter-clockwise, shear in
    degrees, rotation about ``center`` in pixel-index units).  Returns the
    6-tuple ``(a, b, c, d, e, f)`` of ``x_in = a*x + b*y + c; y_in = d*x +
    e*y + f``."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate
    # the inverse of the rotation-with-shear matrix, as torchvision's
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return tuple(m)


def affine_resample(img: torch.Tensor, matrix, interpolation: str = "nearest",
                    fill: float = 0.0) -> torch.Tensor:
    """Resample ``img (..., H, W)`` through the inverse affine map
    ``matrix`` (:func:`inverse_affine_matrix`, x = column, y = row);
    out-of-bounds samples take ``fill``."""
    h, w = img.shape[-2], img.shape[-1]
    a, b, c, d, e, f = matrix
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    x_in = a * xs + b * ys + c
    y_in = d * xs + e * ys + f
    fill_t = torch.full((), fill, dtype=img.dtype, device=img.device)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[..., yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb, vals, fill_t)

    if interpolation == "nearest":
        # grid_sample's nearest: the index nearest to the sample, ties up
        return gather(torch.floor(y_in + 0.5).to(torch.int64),
                      torch.floor(x_in + 0.5).to(torch.int64))
    if interpolation == "bilinear":
        x0, y0 = torch.floor(x_in), torch.floor(y_in)
        wx, wy = x_in - x0, y_in - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
        bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
        return top * (1 - wy) + bot * wy
    raise ValueError(f"Unknown interpolation: {interpolation}")


def rotate_image(img: torch.Tensor, degrees: float, interpolation: str = "nearest",
                 fill: float = 0.0) -> torch.Tensor:
    """Counter-clockwise rotation about the image centre (torchvision
    ``rotate``)."""
    h, w = img.shape[-2], img.shape[-1]
    m = inverse_affine_matrix(-degrees, center=((w - 1) * 0.5, (h - 1) * 0.5))
    return affine_resample(img, m, interpolation, fill)


def shear_image(img: torch.Tensor, deg_x: float = 0.0, deg_y: float = 0.0,
                interpolation: str = "nearest", fill: float = 0.0) -> torch.Tensor:
    """Shear about the image centre (torchvision ``affine(shear=[x, y])``)."""
    h, w = img.shape[-2], img.shape[-1]
    m = inverse_affine_matrix(0.0, shear=(deg_x, deg_y), center=((w - 1) * 0.5, (h - 1) * 0.5))
    return affine_resample(img, m, interpolation, fill)


def _resample_dft(dft: torch.Tensor, resample) -> torch.Tensor:
    """fftshift, ``resample`` the real and imaginary planes, ifftshift."""
    shifted = torch.fft.fftshift(dft, dim=(-2, -1))
    out = torch.complex(resample(shifted.real.contiguous()),
                        resample(shifted.imag.contiguous()))
    return torch.fft.ifftshift(out, dim=(-2, -1))


def rotate_dft_2d_spatial(dft: torch.Tensor, degrees: float) -> torch.Tensor:
    """Rotate a DFT spectrum spatially; the sign flip matches the reference,
    so positive angles rotate the image counter-clockwise
    (``utils/dct_torch_utils.py:232-265``)."""
    return _resample_dft(dft, lambda x: rotate_image(x, -degrees))


def shear_dft_2d_spatial(dft: torch.Tensor, deg_x: float = 0.0,
                         deg_y: float = 0.0) -> torch.Tensor:
    """Shear a DFT spectrum spatially (``utils/dct_torch_utils.py:267-321``)."""
    return _resample_dft(dft, lambda x: shear_image(x, deg_x, deg_y))


def _tukey_window(n: int, alpha: float = 0.4, device=None) -> torch.Tensor:
    """Tukey (tapered cosine) window, ``scipy.signal.windows.tukey``'s."""
    x = torch.linspace(0.0, 1.0, n, device=device)
    edge = alpha / 2.0
    rise = 0.5 * (1.0 + torch.cos(math.pi * (2.0 * x / alpha - 1.0)))
    fall = 0.5 * (1.0 + torch.cos(math.pi * (2.0 * x / alpha - 2.0 / alpha + 1.0)))
    w = torch.where(x < edge, rise, torch.ones_like(x))
    return torch.where(x >= 1.0 - edge, fall, w)


def _apply_window(coeff: torch.Tensor, hp: int, wp: int, alpha: float = 0.4) -> torch.Tensor:
    """Per-block-grid Tukey taper (the reference's ``window=True``,
    ``utils/dct_ops.py:399-403``)."""
    win = (_tukey_window(hp, alpha, coeff.device)[:, None]
           * _tukey_window(wp, alpha, coeff.device)[None, :])
    return coeff * win[:, :, None, None]


def _pad_grid(coeff: torch.Tensor, pad: float | None):
    """Zero-pad the block grid by the factor ``pad`` (centred); returns the
    padded grid, the margins and the original size."""
    h, w = coeff.shape[-4], coeff.shape[-3]
    if not pad:
        return coeff, 0, 0, h, w
    hp, wp = int(h * pad // 1), int(w * pad // 1)
    hm, wm = (hp - h) // 2, (wp - w) // 2
    padded = torch.nn.functional.pad(coeff, (0, 0, 0, 0, wm, wp - w - wm, hm, hp - h - hm))
    return padded, hm, wm, h, w


def _through_dft(coeff: torch.Tensor, pad, window: bool, prepare, resample) -> torch.Tensor:
    """pad -> (window) -> ``prepare`` -> blockshift -> global DFT ->
    ``resample`` -> decompose -> unshift -> crop the padding off."""
    padded, hm, wm, h, w = _pad_grid(coeff, pad)
    hp, wp, kh, kw = padded.shape[-4:]
    if window:
        padded = _apply_window(padded, hp, wp)
    x = blockshift(prepare(padded), axes=(-4, -3))
    dft = resample(combine_blocks_dft(x))
    x = iblockshift(decompose_blocks_dft(dft, hp, wp, kh, kw), axes=(-4, -3))
    if pad:
        x = x[..., hm:hm + h, wm:wm + w, :, :]
    return x


def rotate_block(coeff: torch.Tensor, degrees: float = 45.0, pad: float | None = None,
                 window: bool = False) -> torch.Tensor:
    """Rotate DCT coefficients by ``degrees`` counter-clockwise.  Lossless
    90-degree multiples are factored out first, so the lossy DFT rotation
    stays within +-45 degrees; then blockshift -> global DFT -> spatial
    rotate -> decompose -> unshift.  Reference: ``utils/dct_ops.py:367-434``."""
    sign = 1.0 if degrees == 0 else degrees / abs(degrees)
    deg_remainder = sign * (abs(degrees) % 360.0)
    deg_shifted = (deg_remainder + 360.0 + 45.0) % 360.0
    rot90s = int(deg_shifted // 90.0)
    deg_leftover = -((rot90s * 90.0) - (deg_shifted - 45.0))
    return _through_dft(coeff, pad, window, lambda x: rotate_dct_90deg(x, rotate=rot90s),
                        lambda dft: rotate_dft_2d_spatial(dft, deg_leftover))


def shear_block(coeff: torch.Tensor, deg_x: float = 0.0, deg_y: float = 0.0,
                pad: float | None = None, window: bool = False) -> torch.Tensor:
    """Shear DCT coefficients through the global DFT.
    Reference: ``utils/dct_ops.py:957-1013``."""
    return _through_dft(coeff, pad, window, lambda x: x,
                        lambda dft: shear_dft_2d_spatial(dft, deg_x, deg_y))
