"""The patch embeddings, RGB and DCT (embed_type 1, 2 and 3), and their
position embedding.

Port of ``sincos_position_embedding`` and the DCT embeddings of
``rgbnomore_tpu/models/embeddings.py`` (the reference's
``models/plainvit.py:90-410``): the grouped embedding (1, with SwinV2's patch
4, no sincos and a LayerNorm), the separate one with and without sub-blocks
(2) and the concatenated one (3), and the RGB embedding, a stride-16
convolution and sincos (``PatchEmbeddingRGB``).
Parameter names are flax's, so ``convert.py`` maps each leaf to one key.

Under mixed precision the projection computes in the model's dtype (flax
``torch_dense``), the sincos table is built in that dtype too, as the JAX
package's ``_add_sincos`` builds it in its input's (``embeddings.py:
104-107``), and the LayerNorm returns float32 (``models/layers.py``).
The RGB embedding's convolution is PyTorch's, as the JAX package's is
XLA's: no kernel of either takes part in it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgbnomore_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from rgbnomore_tpu_torch.models.subblock import (
    apply_subblock,
    group_blocks,
    patch_conversion,
    ungroup_blocks,
)

__all__ = ["sincos_position_embedding", "PatchEmbeddingDCTConcat", "PatchEmbeddingDCTGroup",
           "PatchEmbeddingDCTSeparate", "PatchEmbeddingDCTSeparateSubblock",
           "PatchEmbeddingRGB"]


def sincos_position_embedding(h: int, w: int, e: int, *, dtype=torch.float32,
                              device=None) -> torch.Tensor:
    """Fixed 2-D sin-cos position embedding, big_vision layout, (h, w, e).

    ``cat(sin(w), cos(w), sin(h), cos(h))`` with e/4 frequencies each,
    ``freq_k = exp(-k * ln(10000) / (e/4 - 1))``.
    Reference: ``models/plainvit.py:90-121``.

    Every step runs in ``dtype``, the constant ``ln(10000) / (e/4 - 1)``
    rounded to it first, as JAX rounds a Python scalar to the array's dtype:
    in bf16 and fp16 the table is bit-identical to the JAX package's.
    """
    if e % 4:
        raise ValueError("Embedding size should be a multiple of 4")
    nfreq = e // 4
    step = torch.tensor(math.log(10000.0) / (nfreq - 1), dtype=dtype, device=device)
    freqs = torch.exp(-torch.arange(nfreq, dtype=dtype, device=device) * step)
    hh, ww = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    ph = hh.reshape(-1)[:, None] * freqs[None, :]
    pw = ww.reshape(-1)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(pw), torch.cos(pw), torch.sin(ph), torch.cos(ph)], dim=-1)
    return emb.reshape(h, w, e)


def _add_sincos(x: torch.Tensor) -> torch.Tensor:
    """Add the fixed sincos embedding to a (..., h, w, e) feature map, built
    in the map's dtype (``embeddings.py:104-107``)."""
    h, w, e = x.shape[-3:]
    return x + sincos_position_embedding(h, w, e, dtype=x.dtype, device=x.device)


class PatchEmbeddingRGB(nn.Module):
    """The RGB patch embedding (``plainvit.py:123-155``; the JAX
    ``embeddings.py:110-134``): a ``patch_size``-stride convolution of the
    (B, 3, H, W) pixels to ``emb_size`` channels in ``dtype``, plus sincos;
    returns tokens (B, (H / patch)^2, emb_size)."""

    def __init__(self, patch_size: int = 16, emb_size: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection = Conv2d(3, emb_size, patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.projection(x).permute(0, 2, 3, 1)  # (B, h, w, E)
        return _add_sincos(feats).flatten(1, 2)


def _conversion_buffers(module: nn.Module, patch_size: int, chroma_scale: int,
                        use_subblock: bool) -> None:
    """The luma and chroma sub-block conversions of ``patch_size`` as
    non-persistent buffers ``conv_y`` and ``conv_c`` (None where the patch
    needs none), with ``pd_y``, ``comb_y``, ``pd_c`` and ``comb_c``."""
    conv_y, module.pd_y, module.comb_y = patch_conversion(patch_size, use_subblock)
    conv_c, module.pd_c, module.comb_c = patch_conversion(patch_size // chroma_scale,
                                                          use_subblock)
    for name, conv in (("conv_y", conv_y), ("conv_c", conv_c)):
        buf = None if conv is None else torch.from_numpy(np.array(conv, np.float32))
        module.register_buffer(name, buf, persistent=False)


def _patches(x: torch.Tensor, conv, pd: int, combine: bool) -> torch.Tensor:
    """(B, C, H, W, 8, 8) blocks as patches (B, C, h, w, p, p): neighbouring
    blocks combined into one basis (patch > 8), or each block split into
    sub-blocks (patch < 8)."""
    if combine:
        return apply_subblock(group_blocks(x, pd), conv)
    return ungroup_blocks(apply_subblock(x, conv, combine=False), pd)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w, i, j) -> (B, h, w, C*i*j): "b c h w i j -> b h w (c i j)"."""
    b, _, h, w = x.shape[:4]
    return x.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)


class PatchEmbeddingDCTGroup(nn.Module):
    """embed_type 1 — grouped: merge the Y and CbCr coefficients of one
    spatial patch and project them with a single Linear
    (``plainvit.py:157-218``).

    A patch above 8 combines neighbouring blocks into one larger basis; a
    patch below 8 splits each block into sub-blocks (SwinV2's patch 4: luma
    sub-blocks of 4x4, chroma of 2x2).  ``add_sincos`` adds the sincos
    position embedding (the ViT); ``use_norm`` follows the projection with a
    LayerNorm of eps 1e-5 (SwinV2, ``swinv2.py:547-554``).

    ``forward(y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8))`` returns
    tokens (B, L, emb_size), L = (8H / patch_size)^2, in ``dtype`` (float32
    after the norm).
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768,
                 use_subblock: bool = True, chroma_scale: int = 2,
                 add_sincos: bool = True, use_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _conversion_buffers(self, patch_size, chroma_scale, use_subblock)
        # coefficients per patch: patch_size^2 luma, (patch_size/chroma_scale)^2
        # per chroma channel
        in_features = patch_size ** 2 + 2 * (patch_size // chroma_scale) ** 2
        self.projection = Linear(in_features, emb_size, dtype=dtype)
        self.add_sincos = add_sincos
        self.norm = LayerNorm(emb_size, eps=1e-5) if use_norm else None

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        y = _channels_last(_patches(y, self.conv_y, self.pd_y, self.comb_y))
        cbcr = _channels_last(_patches(cbcr, self.conv_c, self.pd_c, self.comb_c))
        feats = self.projection(torch.cat([y, cbcr], dim=-1))
        if self.add_sincos:
            feats = _add_sincos(feats)
        feats = feats.flatten(1, 2)
        return feats if self.norm is None else self.norm(feats)


class PatchEmbeddingDCTSeparate(nn.Module):
    """embed_type 2 without sub-blocks — one Linear per 8x8 block position
    of a patch (``linear_y{i}``, ``linear_c{i}``, each emb_size // n_blocks
    wide, over the block's 64 coefficients), exact GELU, then a
    channel-mixing Linear and sincos (``plainvit.py:220-278``).

    A patch holds (patch_size / 8)^2 luma blocks and 2 (patch_size / 16)^2
    chroma blocks, taken in the order ``(c pdh pdw)``; the chroma patch must
    span at least one block (patch_size >= 16).
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768, chroma_scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if patch_size // chroma_scale < 8:
            raise ValueError("the separate embedding without sub-blocks needs a chroma "
                             f"patch of at least 8, got {patch_size // chroma_scale}")
        self.pd_y = patch_size // 8
        self.pd_c = self.pd_y // chroma_scale
        n_y, n_c = self.pd_y ** 2, 2 * self.pd_c ** 2
        per_block = emb_size // (n_y + n_c)
        self.n_y, self.n_c = n_y, n_c
        for i in range(n_y):
            self.add_module(f"linear_y{i}", Linear(64, per_block, dtype=dtype))
        for i in range(n_c):
            self.add_module(f"linear_c{i}", Linear(64, per_block, dtype=dtype))
        self.linear_mix = Linear((n_y + n_c) * per_block, emb_size, dtype=dtype)

    @staticmethod
    def _blocks(x: torch.Tensor, pd: int) -> torch.Tensor:
        """"b c (h pdh) (w pdw) p1 p2 -> b h w (c pdh pdw) (p1 p2)"."""
        b, c, hp, wp = x.shape[:4]
        x = x.reshape(b, c, hp // pd, pd, wp // pd, pd, 64)
        return x.permute(0, 2, 4, 1, 3, 5, 6).reshape(b, hp // pd, wp // pd, c * pd * pd, 64)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        y = self._blocks(y, self.pd_y)
        cbcr = self._blocks(cbcr, self.pd_c)
        outs = [getattr(self, f"linear_y{i}")(y[:, :, :, i]) for i in range(self.n_y)]
        outs += [getattr(self, f"linear_c{i}")(cbcr[:, :, :, i]) for i in range(self.n_c)]
        feats = self.linear_mix(F.gelu(torch.cat(outs, dim=-1)))
        return _add_sincos(feats).flatten(1, 2)


class PatchEmbeddingDCTSeparateSubblock(nn.Module):
    """embed_type 2 with sub-blocks — the patch's luma and chroma
    coefficients (combined or split as in the grouped embedding) projected
    apart, to 4/6 (``projection_y``) and 2/6 (``projection_c``) of the
    embedding, joined, exact GELU, then ``linear_mix`` added to its own input
    as a residual, then sincos (``plainvit.py:280-351``).

    The residual needs ``emb_size // 6 * 6 == emb_size``: the JAX module
    fails at the add for other widths (ViT-L's 1024 gives 680 + 340 = 1020),
    and this one refuses them at construction.
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768, chroma_scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width_y, width_c = emb_size // 6 * 4, emb_size // 6 * 2
        if width_y + width_c != emb_size:
            raise ValueError(
                f"the separate sub-block embedding's features are {width_y} + {width_c} = "
                f"{width_y + width_c} wide, and its residual needs {emb_size}: emb_size "
                "must be a multiple of 6")
        _conversion_buffers(self, patch_size, chroma_scale, True)
        self.projection_y = Linear(patch_size ** 2, width_y, dtype=dtype)
        self.projection_c = Linear(2 * (patch_size // chroma_scale) ** 2, width_c, dtype=dtype)
        self.linear_mix = Linear(emb_size, emb_size, dtype=dtype)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        y = _channels_last(_patches(y, self.conv_y, self.pd_y, self.comb_y))
        cbcr = _channels_last(_patches(cbcr, self.conv_c, self.pd_c, self.comb_c))
        feats = F.gelu(torch.cat([self.projection_y(y), self.projection_c(cbcr)], dim=-1))
        feats = self.linear_mix(feats) + feats
        return _add_sincos(feats).flatten(1, 2)


class PatchEmbeddingDCTConcat(nn.Module):
    """embed_type 3 — concatenated: the luma and each chroma channel become
    token streams of their own, each patch projected by ``projection_y`` or
    ``projection_c`` (patch_size^2 coefficients of one channel) with the
    sincos of its channel's grid added, joined along the sequence
    (``plainvit.py:353-410``).  On ViT's 28x28 block grid at patch 16 that
    is 196 + 2 x 49 = 294 tokens.
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768, use_subblock: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv, self.pd, self.comb = patch_conversion(patch_size, use_subblock)
        self.register_buffer("conv", None if conv is None else
                             torch.from_numpy(np.array(conv, np.float32)), persistent=False)
        self.projection_y = Linear(patch_size ** 2, emb_size, dtype=dtype)
        self.projection_c = Linear(patch_size ** 2, emb_size, dtype=dtype)

    def _tokens(self, x: torch.Tensor, projection: Linear) -> torch.Tensor:
        x = _patches(x, self.conv, self.pd, self.comb)
        x = projection(x.flatten(-2))  # "b c h w i j -> b c h w (i j)", projected
        return _add_sincos(x).flatten(1, 3)  # per channel; "b c h w e -> b (c h w) e"

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        return torch.cat([self._tokens(y, self.projection_y),
                          self._tokens(cbcr, self.projection_c)], dim=1)
