"""The grouped DCT patch embedding (embed_type 1) and its position embedding.

Port of ``sincos_position_embedding`` and ``PatchEmbeddingDCTGroup`` from
``rgbnomore_tpu/models/embeddings.py`` (the reference's
``models/plainvit.py:90-218``).  The separate (2) and concatenated (3)
embeddings and the RGB embedding are still to be ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from rgbnomore_tpu_torch.models.subblock import apply_subblock, group_blocks, patch_conversion

__all__ = ["sincos_position_embedding", "PatchEmbeddingDCTGroup"]


def sincos_position_embedding(h: int, w: int, e: int, *, dtype=torch.float32,
                              device=None) -> torch.Tensor:
    """Fixed 2-D sin-cos position embedding, big_vision layout, (h, w, e).

    ``cat(sin(w), cos(w), sin(h), cos(h))`` with e/4 frequencies each,
    ``freq_k = exp(-k * ln(10000) / (e/4 - 1))``.
    Reference: ``models/plainvit.py:90-121``.
    """
    if e % 4:
        raise ValueError("Embedding size should be a multiple of 4")
    nfreq = e // 4
    freqs = torch.exp(-torch.arange(nfreq, dtype=dtype, device=device)
                      * (math.log(10000.0) / (nfreq - 1)))
    hh, ww = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    ph = hh.reshape(-1)[:, None] * freqs[None, :]
    pw = ww.reshape(-1)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(pw), torch.cos(pw), torch.sin(ph), torch.cos(ph)], dim=-1)
    return emb.reshape(h, w, e)


class PatchEmbeddingDCTGroup(nn.Module):
    """embed_type 1 — grouped: merge the Y and CbCr coefficients of one
    spatial patch and project them with a single Linear, then add the sincos
    position embedding (``plainvit.py:157-218``).

    ``forward(y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8))`` returns
    tokens (B, H*W/pd^2, emb_size).
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768,
                 use_subblock: bool = True, chroma_scale: int = 2):
        super().__init__()
        conv_y, self.pd_y, comb_y = patch_conversion(patch_size, use_subblock)
        conv_c, self.pd_c, comb_c = patch_conversion(patch_size // chroma_scale,
                                                     use_subblock)
        if not (comb_y and comb_c):
            raise NotImplementedError(
                f"patch_size {patch_size} splits blocks into sub-blocks; that "
                "path is still to be ported (ROADMAP.md, port queue: other "
                "transfers and embeddings)")
        for name, conv in (("conv_y", conv_y), ("conv_c", conv_c)):
            buf = None if conv is None else torch.from_numpy(np.array(conv, np.float32))
            self.register_buffer(name, buf, persistent=False)
        in_features = (self.pd_y * 8) ** 2 + 2 * (self.pd_c * 8) ** 2
        self.projection = nn.Linear(in_features, emb_size)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        y = apply_subblock(group_blocks(y, self.pd_y), self.conv_y)
        cbcr = apply_subblock(group_blocks(cbcr, self.pd_c), self.conv_c)
        # "b c h w i j -> b h w (c i j)"
        b, _, h, w = y.shape[:4]
        y = y.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)
        cbcr = cbcr.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)
        feats = self.projection(torch.cat([y, cbcr], dim=-1))
        e = feats.shape[-1]
        feats = feats + sincos_position_embedding(h, w, e, dtype=feats.dtype,
                                                  device=feats.device)
        return feats.reshape(b, h * w, e)
