"""Structural DCT-block operations (PyTorch): combine / decompose, resize,
crop, flips.

Port of ``rgbnomore_tpu/ops/blocks.py`` (the reference's
``utils/dct_ops.py``, cited per function).  Coefficients are laid out
``(..., H, W, 8, 8)``: leading axes (usually ``C`` or ``B, C``), the block
grid, then the intra-block frequencies.  Values stay float32 (complex64 on
the DFT route); the products are the JAX package's ``HIGHEST`` ones, and
they run in full float32 on the card too (``float32_products``: never
TF32).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from rgbnomore_tpu_torch.ops.basis import (
    KSIZE,
    conversion_matrix,
    conversion_matrix_dft,
    resize_axis_operator,
)

__all__ = [
    "blockshift",
    "iblockshift",
    "combine_blocks",
    "decompose_blocks",
    "combine_blocks_dft",
    "decompose_blocks_dft",
    "upsample_dct",
    "downsample_dct",
    "resize_dct",
    "crop_dct",
    "flip_dct",
    "float32_products",
    "rotate_dct_90deg",
]


@contextlib.contextmanager
def float32_products():
    """Float32 matrix products in full float32 inside the block, whatever
    the process chose (``torch.set_float32_matmul_precision``): the
    counterpart of the JAX package's ``precision=HIGHEST``.  A TF32 product
    would move the pixel decode's rounding and the DFT route's clamp."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host matrix of ``ops.basis`` on ``like``'s device."""
    return torch.from_numpy(np.array(arr)).to(like.device)


def _to_flat(x: torch.Tensor) -> torch.Tensor:
    """``... h w kh kw -> ... (h kh) (w kw)``."""
    *lead, h, w, kh, kw = x.shape
    return x.transpose(-3, -2).reshape(*lead, h * kh, w * kw)


def _from_flat(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """``... (h kh) (w kw) -> ... h w kh kw``."""
    *lead, hk, wk = x.shape
    return x.reshape(*lead, hk // kh, kh, wk // kw, kw).transpose(-3, -2)


def blockshift(coeff: torch.Tensor, axes=(-2, -1)) -> torch.Tensor:
    """Roll so the origin moves to the centre (fftshift-like).
    Reference: ``utils/dct_ops.py:62-77``."""
    h, w = coeff.shape[axes[0]], coeff.shape[axes[1]]
    return torch.roll(coeff, (h // 2, w // 2), dims=axes)


def iblockshift(coeff: torch.Tensor, axes=(-2, -1)) -> torch.Tensor:
    """Inverse of :func:`blockshift`.  Reference: ``utils/dct_ops.py:79-96``."""
    h, w = coeff.shape[axes[0]], coeff.shape[axes[1]]
    return torch.roll(coeff, (h - h // 2, w - w // 2), dims=axes)


def combine_blocks(coeff: torch.Tensor) -> torch.Tensor:
    """Merge the 8x8 block-DCT grid into one global DCT coefficient map,
    ``(..., H, W, KH, KW) -> (..., H*KH, W*KW)``.
    Reference: ``utils/dct_ops.py:237-267``."""
    *_, h, w, kh, kw = coeff.shape
    conv_l = _const(conversion_matrix(kh, h), coeff)
    conv_m = conv_l if (h == w and kh == kw) else _const(conversion_matrix(kw, w), coeff)
    with float32_products():
        out = conv_l @ _to_flat(coeff.to(torch.float32))
        return out @ conv_m.T


def decompose_blocks(coeff: torch.Tensor, h: int, w: int, kh: int = KSIZE,
                     kw: int = KSIZE) -> torch.Tensor:
    """Inverse of :func:`combine_blocks`: ``(..., H*KH, W*KW) -> (..., H, W,
    KH, KW)``.  Reference: ``utils/dct_ops.py:269-301``."""
    conv_l = _const(conversion_matrix(kh, h), coeff)
    conv_m = conv_l if (h == w and kh == kw) else _const(conversion_matrix(kw, w), coeff)
    with float32_products():
        out = conv_l.T @ coeff.to(torch.float32)
        out = out @ conv_m
    return _from_flat(out, kh, kw)


def combine_blocks_dft(coeff: torch.Tensor) -> torch.Tensor:
    """Merge the block-DCT grid into one global *DFT* coefficient map,
    complex64 ``(..., H*KH, W*KW)``.  The row transform is scaled by
    ``sqrt(H*KH)`` and the column transform by ``1/sqrt(W*KW)``, the
    reference's convention (``utils/dct_ops.py:303-332``)."""
    *_, h, w, kh, kw = coeff.shape
    conv_l = _const(conversion_matrix_dft(kh, h), coeff)
    conv_m = conv_l if (h == w and kh == kw) else _const(conversion_matrix_dft(kw, w), coeff)
    flat = _to_flat(coeff.to(torch.complex64))
    with float32_products():
        out = (conv_l @ flat) * math.sqrt(kh * h)
        return (out @ conv_m.conj().T) / math.sqrt(kw * w)


def decompose_blocks_dft(coeff: torch.Tensor, h: int, w: int, kh: int = KSIZE,
                         kw: int = KSIZE) -> torch.Tensor:
    """Inverse of :func:`combine_blocks_dft`; returns the real part (float32).
    Reference: ``utils/dct_ops.py:334-365``."""
    conv_l = _const(conversion_matrix_dft(kh, h), coeff)
    conv_m = conv_l if (h == w and kh == kw) else _const(conversion_matrix_dft(kw, w), coeff)
    with float32_products():
        out = (conv_l.conj().T @ coeff.to(torch.complex64)) / math.sqrt(kh * h)
        out = (out @ conv_m) * math.sqrt(kw * w)
    return _from_flat(out.real.contiguous(), kh, kw)


def upsample_dct(coeff: torch.Tensor, l: int = 1, m: int = 1) -> torch.Tensor:  # noqa: E741
    """Upsample the block grid by ``l`` (H) x ``m`` (W): each block's
    spectrum zero-padded to ``(l*8, m*8)`` (scaled by ``sqrt(l*m)``) and
    decomposed back into ``l x m`` blocks.
    Reference: ``utils/dct_ops.py:436-482``."""
    x = coeff.to(torch.float32)
    if l == 1 and m == 1:
        return x
    *lead, h, w, kh, kw = coeff.shape
    conv_l = _const(conversion_matrix(kh, l), coeff)
    conv_m = conv_l if (l == m and kh == kw) else _const(conversion_matrix(kw, m), coeff)
    x = torch.nn.functional.pad(x * math.sqrt(l * m), (0, (m - 1) * kw, 0, (l - 1) * kh))
    with float32_products():
        x = conv_l.T @ x
        x = x @ conv_m
    x = x.reshape(*lead, h, w, l, kh, m, kw)  # ... h w (l kh) (m kw)
    return x.permute(*range(len(lead)), -6, -4, -5, -2, -3, -1).reshape(
        *lead, h * l, w * m, kh, kw)


def downsample_dct(coeff: torch.Tensor, l: int = 1, m: int = 1) -> torch.Tensor:  # noqa: E741
    """Downsample the block grid by ``l`` (H) x ``m`` (W): groups of ``l x
    m`` blocks combined into one spectrum, truncated to its lowest 8x8
    coefficients (scaled by ``1/sqrt(l*m)``).
    Reference: ``utils/dct_ops.py:484-527``."""
    x = coeff.to(torch.float32)
    if l == 1 and m == 1:
        return x
    *lead, hl, wm, kh, kw = coeff.shape
    h, w = hl // l, wm // m
    conv_l = _const(conversion_matrix(kh, l), coeff)
    conv_m = conv_l if (l == m and kh == kw) else _const(conversion_matrix(kw, m), coeff)
    x = x.reshape(*lead, h, l, w, m, kh, kw)  # ... (h l) (w m) kh kw
    x = x.permute(*range(len(lead)), -6, -4, -5, -2, -3, -1).reshape(
        *lead, h, w, l * kh, m * kw)
    with float32_products():
        x = conv_l @ x
        x = x @ conv_m.T
    return x[..., :kh, :kw] / math.sqrt(l * m)


def resize_dct(coeff: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the block grid to ``size x size`` with one product per axis
    (``ops.basis.resize_axis_operator``: the reference's gcd-based
    upsample-then-downsample, ``utils/dct_ops.py:529-580``, pre-composed)."""
    *_, h, w, kh, kw = coeff.shape
    if h == size and w == size:
        return coeff.to(torch.float32)
    r_h = _const(resize_axis_operator(h, size, kh), coeff)
    r_w = r_h if (h == w and kh == kw) else _const(resize_axis_operator(w, size, kw), coeff)
    with float32_products():
        x = r_h @ _to_flat(coeff.to(torch.float32))
        x = x @ r_w.T
    return _from_flat(x, kh, kw)


def crop_dct(coeff: torch.Tensor, top: int, left: int, height: int,
             width: int) -> torch.Tensor:
    """Crop ``height x width`` blocks at ``(top, left)``; out-of-range is
    zero-padded (``top``/``left`` may be negative and the crop may pass the
    edges), as ``utils/dct_ops.py:584-599``."""
    *_, h, w, _, _ = coeff.shape
    pad_top, pad_left = max(-top, 0), max(-left, 0)
    pad_bottom, pad_right = max(top + height - h, 0), max(left + width - w, 0)
    if pad_top or pad_left or pad_bottom or pad_right:
        coeff = torch.nn.functional.pad(
            coeff, (0, 0, 0, 0, pad_left, pad_right, pad_top, pad_bottom))
        top += pad_top
        left += pad_left
    return coeff[..., top:top + height, left:left + width, :, :]


def _odd_sign(n: int, like: torch.Tensor) -> torch.Tensor:
    """(+1, -1, +1, ...) of length ``n``."""
    sign = torch.ones(n, dtype=like.dtype, device=like.device)
    sign[1::2] = -1
    return sign


def flip_dct(coeff: torch.Tensor, direction: str = "horizontal",
             fixed_pos: bool = False) -> torch.Tensor:
    """Exact flip: flip the block grid, then negate odd-frequency columns
    (horizontal) or rows (vertical).  ``fixed_pos`` skips the grid flip (used
    inside the 90-degree rotation)."""
    *_, kh, kw = coeff.shape
    hax = coeff.dim() - 4
    if direction == "horizontal":
        if not fixed_pos:
            coeff = torch.flip(coeff, dims=(hax + 1,))
        return coeff * _odd_sign(kw, coeff)
    if direction == "vertical":
        if not fixed_pos:
            coeff = torch.flip(coeff, dims=(hax,))
        return coeff * _odd_sign(kh, coeff)[:, None]
    raise ValueError(f"Unknown flip direction: {direction}")


def rotate_dct_90deg(coeff: torch.Tensor, rotate: int = 0) -> torch.Tensor:
    """Exact rotation by multiples of 90 degrees (counter-clockwise
    positive): rotate the block grid, transpose each block, apply the flip
    sign pattern."""
    hax = coeff.dim() - 4
    grid_axes = (hax, hax + 1)
    r = rotate % 4
    if r == 0:
        return coeff
    if r == 3:  # 90 degrees clockwise
        out = torch.rot90(coeff, k=-1, dims=grid_axes).transpose(-2, -1)
        return flip_dct(out, direction="horizontal", fixed_pos=True)
    if r == 2:  # 180 degrees
        return flip_dct(flip_dct(coeff, direction="vertical"), direction="horizontal")
    out = torch.rot90(coeff, k=1, dims=grid_axes).transpose(-2, -1)  # 90 ccw
    return flip_dct(out, direction="vertical", fixed_pos=True)
