"""Subblock conversion helpers for the DCT patch embedding.

Port of ``patch_conversion``, ``apply_subblock``, ``group_blocks`` and
``ungroup_blocks`` from ``rgbnomore_tpu/models/subblock.py`` (the
reference's ``patch2subblock`` / ``apply_subblock`` / ``patch2rearrange``,
``models/plainvit.py:19-88``): a patch larger than the 8x8 JPEG block is
formed by *combining* adjacent blocks into one larger DCT basis; a smaller
patch by *decomposing* each 8x8 block into sub-blocks.
"""

from __future__ import annotations

import torch

from rgbnomore_tpu_torch.ops.basis import conversion_matrix

__all__ = ["patch_conversion", "apply_subblock", "group_blocks", "ungroup_blocks"]


def patch_conversion(patch_size: int, use_subblock: bool = True):
    """Conversion matrix + grouping factor for a patch size.

    Returns ``(convmat | None, patch_dim, combine)`` where ``patch_dim`` is
    how many blocks group per side (patch > 8) or how many sub-blocks an 8x8
    block splits into per side (patch < 8), and ``combine`` says which
    direction applies.
    """
    if patch_size < 2 or patch_size & (patch_size - 1):
        raise ValueError(f"Patch size must be a power of two >= 2, got {patch_size}")
    if patch_size > 8:
        patch_dim = patch_size // 8
        conv = conversion_matrix(8, patch_dim) if use_subblock else None
        return conv, patch_dim, True
    if patch_size == 8:
        return None, 1, True
    patch_dim = 8 // patch_size
    if not use_subblock:
        raise ValueError("patch_size < 8 requires subblock conversion")
    return conversion_matrix(patch_size, patch_dim), patch_dim, False


def apply_subblock(coeff: torch.Tensor, convmat: torch.Tensor | None,
                   combine: bool = True) -> torch.Tensor:
    """Apply subblock conversion on the trailing two axes.

    ``combine=True``: project stacked small-block coefficients onto the large
    basis (``C x Cᵀ``); ``False``: the inverse (``Cᵀ x C``).
    Reference: ``models/plainvit.py:50-69``.
    """
    if convmat is None:
        return coeff
    if combine:
        return convmat @ coeff @ convmat.T
    return convmat.T @ coeff @ convmat


def group_blocks(coeff: torch.Tensor, patch_dim: int) -> torch.Tensor:
    """(B, C, H*pd, W*pd, k, k) -> (B, C, H, W, pd*k, pd*k): stack a pd x pd
    neighbourhood of blocks into one large block (``plainvit.py:83``)."""
    b, c, hp, wp, k1, k2 = coeff.shape
    pd = patch_dim
    x = coeff.reshape(b, c, hp // pd, pd, wp // pd, pd, k1, k2)
    x = x.permute(0, 1, 2, 4, 3, 6, 5, 7)
    return x.reshape(b, c, hp // pd, wp // pd, pd * k1, pd * k2)


def ungroup_blocks(coeff: torch.Tensor, patch_dim: int) -> torch.Tensor:
    """(B, C, H, W, pd*k, pd*k) -> (B, C, H*pd, W*pd, k, k): split each block
    into a pd x pd grid of sub-blocks (``plainvit.py:86``).  A sub-block's
    coefficient (p1, p2) sits at row ``p1 * pd + i`` and column ``p2 * pd +
    j`` of the block, for the sub-block (i, j) of the grid."""
    b, c, h, w, k1, k2 = coeff.shape
    pd = patch_dim
    x = coeff.reshape(b, c, h, w, k1 // pd, pd, k2 // pd, pd)
    x = x.permute(0, 1, 2, 5, 3, 7, 4, 6)
    return x.reshape(b, c, h * pd, w * pd, k1 // pd, k2 // pd)
