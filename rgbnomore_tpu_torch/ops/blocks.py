"""Exact block-grid geometry in the DCT domain (PyTorch).

Port of ``flip_dct`` and ``rotate_dct_90deg`` of
``rgbnomore_tpu/ops/blocks.py`` (reference ``utils/dct_ops.py:99-130,
601-621``).  Coefficients are laid out ``(..., H, W, 8, 8)``.
"""

from __future__ import annotations

import torch

__all__ = ["flip_dct", "rotate_dct_90deg"]


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
