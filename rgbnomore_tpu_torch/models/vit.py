"""Vision Transformer over JPEG DCT coefficients or RGB pixels (PyTorch).

Port of ``rgbnomore_tpu/models/vit.py`` (the reference's
``models/plainvit.py:412-612``) with each of its patch embeddings: RGB (a
stride-16 convolution, ``pixel_space="rgb"``) and the DCT ones, grouped
(``ver=1``), separate (``ver=2``, with or without sub-blocks) and
concatenated (``ver=3``, 1.5x the tokens: 294 on the 28x28 block grid).
The quirks of the reference carry over: the
attention logits are scaled by ``1/sqrt(emb_size)``, not
``1/sqrt(head_dim)``; qkv is one Linear split into contiguous thirds; the
softmax runs in float32; GELU is exact; LayerNorm eps is 1e-5; the head is
LN -> mean -> Linear -> tanh -> Linear with float32 logits.

Mixed precision follows the flax modules' dtype flow (``models/layers.py``):
every Linear but the last computes in ``dtype``; the tokens are cast to it
after the embedding (``vit.py:184``), so the residual stream stays in it
(bf16 + bf16, ``vit.py:87-106``); each LayerNorm returns float32, which the
next Linear casts back; the head's ``linear2`` takes a float32 input and
gives float32 logits (``vit.py:119-128``).

Dropout is the JAX ViT's (``vit.py:95-106``): in training at ``drop_p``,
after the attention projection, after GELU and after mlp2, never on the
attention probabilities, so the kernels stay on the path at every rate.
Its masks come from the forward's ``DropoutMasks`` (``models/layers.py``).

Every encoder block's attention runs through ``ops.attention.fused_attention``:
on the GPU that is a hand-written CUDA kernel (3xTF32 in float32, the
half-precision kernels in bf16 and fp16), 12 launches per forward.  Module
and parameter names follow the flax ones (``patchembed``, ``encoder_{i}``,
``head``) so that ``convert.py`` maps a flax parameter tree onto
``state_dict`` keys one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rgbnomore_tpu_torch.models.embeddings import (
    PatchEmbeddingDCTConcat,
    PatchEmbeddingDCTGroup,
    PatchEmbeddingDCTSeparate,
    PatchEmbeddingDCTSeparateSubblock,
    PatchEmbeddingRGB,
)
from rgbnomore_tpu_torch.models.layers import Dropout, DropoutMasks, LayerNorm, Linear
from rgbnomore_tpu_torch.ops.attention import fused_attention

__all__ = ["MultiHeadAttention", "EncoderBlock", "ClassificationHead", "ViT"]

LN_EPS = 1e-5  # torch LayerNorm default, for checkpoint parity


class MultiHeadAttention(nn.Module):
    """Fused-QKV attention with the reference's emb_size**0.5 logit scaling.

    ``attention`` is the function that computes ``softmax(scale * QKᵀ) V``;
    it is ``fused_attention`` (the CUDA kernel on the GPU), and a check may
    swap in ``ops.attention.attention_plain`` to hold the two against each
    other.
    """

    def __init__(self, emb_size: int, num_heads: int = 8, head_size: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.scale = 1.0 / math.sqrt(emb_size)
        inner = num_heads * head_size
        self.qkv = Linear(emb_size, 3 * inner, dtype=dtype)
        self.projection = Linear(inner, emb_size, dtype=dtype)
        self.attention = fused_attention

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        inner = self.num_heads * self.head_size
        # contiguous thirds, "b n (h d) -> b h n d" each
        q, k, v = (
            t.reshape(b, n, self.num_heads, self.head_size).transpose(1, 2).contiguous()
            for t in self.qkv(x).split(inner, dim=-1)
        )
        out = self.attention(q, k, v, self.scale)
        out = out.transpose(1, 2).reshape(b, n, inner)
        return self.projection(out)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (``plainvit.py:493-529``)."""

    def __init__(self, emb_size: int, num_heads: int, head_size: int = 64,
                 forward_expansion: int = 4, drop_p: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(emb_size, eps=LN_EPS)
        self.mha = MultiHeadAttention(emb_size, num_heads, head_size, dtype)
        self.ln2 = LayerNorm(emb_size, eps=LN_EPS)
        self.mlp1 = Linear(emb_size, forward_expansion * emb_size, dtype=dtype)
        self.mlp2 = Linear(forward_expansion * emb_size, emb_size, dtype=dtype)
        self.drop = Dropout(drop_p)  # the JAX block's drop_p = forward_drop_p

    def forward(self, x: torch.Tensor, dropout: DropoutMasks | None = None) -> torch.Tensor:
        x = x + self.drop(self.mha(self.ln1(x)), dropout)
        h = self.drop(F.gelu(self.mlp1(self.ln2(x))), dropout)
        return x + self.drop(self.mlp2(h), dropout)


class ClassificationHead(nn.Module):
    """LN -> mean pool -> Linear -> Tanh -> Linear (``plainvit.py:542-557``)."""

    def __init__(self, emb_size: int, n_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(emb_size, eps=LN_EPS)
        self.linear1 = Linear(emb_size, emb_size, dtype=dtype)
        self.linear2 = nn.Linear(emb_size, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.linear1(self.ln(x).mean(dim=1)))
        return self.linear2(x.to(torch.float32))  # float32 logits


class ViT(nn.Module):
    """ViT over (y, cbcr) DCT coefficients or RGB pixels.

    ``forward(y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8), dropout)``
    (DCT) or ``forward(x (B, 3, H, W), dropout=...)`` (``pixel_space="rgb"``)
    returns (B, n_classes) float32 logits; ``dtype`` is the compute dtype of
    mixed precision (float32, bf16 or fp16); in training at ``drop_p > 0``,
    ``dropout`` gives the masks of the 3 x depth dropout sites.  ``ver``
    picks the DCT embedding (1, 2 with or without sub-blocks, 3).
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768, depth: int = 12,
                 num_heads: int = 8, head_size: int = 64, n_classes: int = 1000,
                 drop_p: float = 0.0, pixel_space: str = "DCT", ver: int = 1,
                 use_subblock: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        space = pixel_space.lower()
        if space not in ("rgb", "dct"):
            raise ValueError(f"Unknown pixel space: {pixel_space}")
        if space == "rgb":
            embed = PatchEmbeddingRGB(patch_size, emb_size, dtype=dtype)
        elif ver == 1:
            embed = PatchEmbeddingDCTGroup(patch_size, emb_size, use_subblock, dtype=dtype)
        elif ver == 2 and not use_subblock:
            embed = PatchEmbeddingDCTSeparate(patch_size, emb_size, dtype=dtype)
        elif ver == 2:
            embed = PatchEmbeddingDCTSeparateSubblock(patch_size, emb_size, dtype=dtype)
        elif ver == 3:
            embed = PatchEmbeddingDCTConcat(patch_size, emb_size, use_subblock, dtype=dtype)
        else:
            raise ValueError(f"Unknown embed version: {ver}")
        self.depth = depth
        self.dtype = dtype
        self.patchembed = embed
        for i in range(depth):
            self.add_module(f"encoder_{i}", EncoderBlock(emb_size, num_heads, head_size,
                                                          drop_p=drop_p, dtype=dtype))
        self.head = ClassificationHead(emb_size, n_classes, dtype)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor | None = None,
                dropout: DropoutMasks | None = None) -> torch.Tensor:
        inputs = (y,) if isinstance(self.patchembed, PatchEmbeddingRGB) else (y, cbcr)
        tokens = self.patchembed(*inputs).to(self.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"encoder_{i}")(tokens, dropout)
        return self.head(tokens)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, bias_init: str = "torch") -> None:
        """Draw every parameter from ``generator`` with the JAX package's
        init family: Linear and convolution weights and biases
        U(+-1/sqrt(fan_in)) (torch's default; ``bias_init="zeros"`` zeroes
        the biases), LayerNorm 1 and 0.
        """
        if bias_init not in ("torch", "zeros"):
            raise ValueError(f"unknown bias init family {bias_init!r}")
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())  # fan_in
                m.weight.uniform_(-bound, bound, generator=generator)
                if bias_init == "zeros":
                    m.bias.zero_()
                else:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
