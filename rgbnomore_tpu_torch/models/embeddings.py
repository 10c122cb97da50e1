"""The grouped DCT patch embedding (embed_type 1) and its position embedding.

Port of ``sincos_position_embedding`` and ``PatchEmbeddingDCTGroup`` from
``rgbnomore_tpu/models/embeddings.py`` (the reference's
``models/plainvit.py:90-218``), with SwinV2's patch 4 (sub-blocks), no
sincos and a LayerNorm.  The separate (2) and concatenated (3) embeddings
and the RGB embedding are still to be ported.

Under mixed precision the projection computes in the model's dtype (flax
``torch_dense``), the sincos table is built in that dtype too, as the JAX
package's ``_add_sincos`` builds it in its input's (``embeddings.py:
104-107``), and the LayerNorm returns float32 (``models/layers.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from rgbnomore_tpu_torch.models.layers import LayerNorm, Linear
from rgbnomore_tpu_torch.models.subblock import (
    apply_subblock,
    group_blocks,
    patch_conversion,
    ungroup_blocks,
)

__all__ = ["sincos_position_embedding", "PatchEmbeddingDCTGroup"]


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
        conv_y, self.pd_y, self.comb_y = patch_conversion(patch_size, use_subblock)
        conv_c, self.pd_c, self.comb_c = patch_conversion(patch_size // chroma_scale,
                                                          use_subblock)
        for name, conv in (("conv_y", conv_y), ("conv_c", conv_c)):
            buf = None if conv is None else torch.from_numpy(np.array(conv, np.float32))
            self.register_buffer(name, buf, persistent=False)
        # coefficients per patch: patch_size^2 luma, (patch_size/chroma_scale)^2
        # per chroma channel
        in_features = patch_size ** 2 + 2 * (patch_size // chroma_scale) ** 2
        self.projection = Linear(in_features, emb_size, dtype=dtype)
        self.add_sincos = add_sincos
        self.norm = LayerNorm(emb_size, eps=1e-5) if use_norm else None

    @staticmethod
    def _patches(x: torch.Tensor, conv, pd: int, combine: bool) -> torch.Tensor:
        if combine:
            return apply_subblock(group_blocks(x, pd), conv)
        return ungroup_blocks(apply_subblock(x, conv, combine=False), pd)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        y = self._patches(y, self.conv_y, self.pd_y, self.comb_y)
        cbcr = self._patches(cbcr, self.conv_c, self.pd_c, self.comb_c)
        # "b c h w i j -> b h w (c i j)"
        b, _, h, w = y.shape[:4]
        y = y.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)
        cbcr = cbcr.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)
        feats = self.projection(torch.cat([y, cbcr], dim=-1))
        e = feats.shape[-1]
        if self.add_sincos:
            feats = feats + sincos_position_embedding(h, w, e, dtype=feats.dtype,
                                                      device=feats.device)
        feats = feats.reshape(b, h * w, e)
        return feats if self.norm is None else self.norm(feats)
