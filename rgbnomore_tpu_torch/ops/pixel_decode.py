"""On-device JPEG tail decode: DCT coefficients -> RGB pixels (PyTorch).

Port of ``rgbnomore_tpu/ops/pixel_decode.py``.  The RGB domain ships the
same sparse coefficient rows as the DCT domain and rebuilds pixels on the
device; each stage follows libjpeg's decode, so the output matches a host
``codec.read_jpeg`` within +-3 gray levels (its fixed-point IDCT against
this float one; the upsample and colour conversion are integer-exact):

- ``idct_plane``: float IDCT, level shift, round, range limit (the contract
  of jidctint.c, with the orthonormal basis).  Its two 8x8 products run in
  full float32 on the card (``blocks.float32_products``), never in TF32,
  and in the JAX package's order, ``(A^T C) A``.
- ``fancy_upsample_2x``: jdsample.c's ``h2v2_fancy_upsample`` in int32.
- ``ycbcr_to_rgb_pixels``: jdcolor.c's ``ycc_rgb_convert``, 16.16 fixed
  point in int32 (PyTorch's ``>>`` on int32 is arithmetic, as libjpeg's).
- ``decode_rgb_pixels``: the whole chain on dequantized (Y, CbCr) batches.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbnomore_tpu_torch.ops.basis import dct_basis_matrix
from rgbnomore_tpu_torch.ops.blocks import float32_products

__all__ = ["idct_plane", "fancy_upsample_2x", "ycbcr_to_rgb_pixels", "decode_rgb_pixels"]


def idct_plane(coeff: torch.Tensor) -> torch.Tensor:
    """Dequantized coefficient blocks (..., H, W, 8, 8) -> samples (..., 8H,
    8W), level-shifted (+128), rounded (half to even), range-limited to
    [0, 255], float32: ``x = A^T C A`` with the orthonormal DCT-II analysis
    matrix ``A``."""
    a = torch.from_numpy(np.array(dct_basis_matrix(8))).to(coeff.device)
    with float32_products():
        x = (a.T @ coeff.to(torch.float32)) @ a
    *lead, h, w, _, _ = x.shape
    x = x.transpose(-3, -2).reshape(*lead, h * 8, w * 8)
    return torch.clamp(torch.round(x + 128.0), 0.0, 255.0)


def fancy_upsample_2x(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg ``h2v2_fancy_upsample`` (jdsample.c): (..., h, w)
    integer-valued samples -> (..., 2h, 2w) float32.  Each output pixel
    weighs its 4 nearest inputs 9:3:3:1 with libjpeg's rounding: vertically
    ``cs = 3*near + far`` (edge rows replicate), horizontally ``even = (3*cs
    + cs_left + 8) >> 4``, ``odd = (3*cs + cs_right + 7) >> 4`` (edge
    columns replicate)."""
    p = plane.to(torch.int32)
    up = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    down = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    cs = torch.stack([3 * p + up, 3 * p + down], dim=-2)  # (..., h, 2, w): rows 2i, 2i+1
    *lead, h, _, w = cs.shape
    cs = cs.reshape(*lead, 2 * h, w)
    left = torch.cat([cs[..., :1], cs[..., :-1]], dim=-1)
    right = torch.cat([cs[..., 1:], cs[..., -1:]], dim=-1)
    out = torch.stack([(3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4], dim=-1)
    return out.reshape(*lead, 2 * h, 2 * w).to(torch.float32)


def ycbcr_to_rgb_pixels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ``ycc_rgb_convert``, bit-exact: planes (..., H, W) in [0,
    255] -> (..., 3, H, W) clipped RGB float32, with libjpeg's 16.16
    fixed-point constants (``FIX(x) = round(x * 65536)``, ``ONE_HALF`` added
    once) and arithmetic-shift rounding, all in int32."""
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    half = 32768
    r = yi + ((91881 * cri + half) >> 16)  # FIX(1.40200)
    g = yi + ((-22554 * cbi + -46802 * cri + half) >> 16)  # -FIX(0.34414), -FIX(0.71414)
    b = yi + ((116130 * cbi + half) >> 16)  # FIX(1.77200)
    return torch.clamp(torch.stack([r, g, b], dim=-3), 0, 255).to(torch.float32)


def decode_rgb_pixels(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Dequantized batches ``y`` (B, 1, H, W, 8, 8), ``c`` (B, 2, H/2, W/2,
    8, 8) -> RGB pixels (B, 3, 8H, 8W) float32 with uint8 values.  Grayscale
    sources arrive with zero chroma blocks, which decode to neutral Cb = Cr
    = 128; canvas area beyond the image (Y DCs of -1024) decodes to black."""
    return ycbcr_to_rgb_pixels(idct_plane(y[:, 0]), fancy_upsample_2x(idct_plane(c[:, 0])),
                               fancy_upsample_2x(idct_plane(c[:, 1])))
