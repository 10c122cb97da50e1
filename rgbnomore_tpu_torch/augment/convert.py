"""RGB <-> DCT conversion, the pixel-space oracles (host side).

Port of ``rgbnomore_tpu/augment/convert.py``: the reference's
``rgb_to_dct`` / ``ycbcr_to_rgb`` transforms
(``utils/custom_transforms.py:1140-1196``) on the port's C++ codec.  The
tests use them to hold the DCT-domain augmentations against pixels.
"""

from __future__ import annotations

import numpy as np

from rgbnomore_tpu_torch import codec

__all__ = ["rgb_to_dct", "ycbcr_to_rgb"]


def rgb_to_dct(img: np.ndarray):
    """uint8 CHW pixels -> quantized (Y, CbCr) coefficient blocks at quality
    100: libjpeg's quantization, bit-exact, by the in-memory encode-reread
    (``custom_transforms.py:1174-1196``)."""
    _, _, y, cbcr = codec.quantize_at_quality(np.asarray(img, np.uint8), quality=100)
    return y, cbcr


def ycbcr_to_rgb(y: np.ndarray, cbcr: np.ndarray) -> np.ndarray:
    """Dequantized float DCT coefficients -> uint8 CHW pixels, the
    reference's convention (``custom_transforms.py:1140-1171``): halve the
    coefficients, round to int16 and decode with a constant quant table of 2,
    so that the scaling cancels."""
    y, cbcr = np.asarray(y), np.asarray(cbcr)
    _, h, w, kh, kw = y.shape
    _, ch, cw, _, _ = cbcr.shape
    dims = np.asarray([[h * kh, w * kw], [ch * kh, cw * kw], [ch * kh, cw * kw]], np.int32)
    quant2 = np.full((3, 8, 8), 2, np.int16)
    y_q = np.clip(np.round(y / 2.0), -1024, 1016).astype(np.int16)
    c_q = np.clip(np.round(cbcr / 2.0), -1024, 1016).astype(np.int16)
    return codec.decode_coeff(dims, quant2, y_q, c_q)
