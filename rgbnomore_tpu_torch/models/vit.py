"""Vision Transformer over JPEG DCT coefficients (PyTorch).

Port of ``rgbnomore_tpu/models/vit.py`` (the reference's
``models/plainvit.py:412-612``) for the DCT domain with the grouped patch
embedding (``ver=1``).  The quirks of the reference carry over: the
attention logits are scaled by ``1/sqrt(emb_size)``, not
``1/sqrt(head_dim)``; qkv is one Linear split into contiguous thirds; the
softmax runs in float32; GELU is exact; LayerNorm eps is 1e-5; the head is
LN -> mean -> Linear -> tanh -> Linear with float32 logits.

Every encoder block's attention runs through ``ops.attention.fused_attention``:
on the GPU that is the hand-written CUDA kernel, 12 launches per ViT-Ti
forward.  Module and parameter names follow the flax ones
(``patchembed``, ``encoder_{i}``, ``head``) so that ``convert.py`` maps a flax
parameter tree onto ``state_dict`` keys one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rgbnomore_tpu_torch.models.embeddings import PatchEmbeddingDCTGroup
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

    def __init__(self, emb_size: int, num_heads: int = 8, head_size: int = 64):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.scale = 1.0 / math.sqrt(emb_size)
        inner = num_heads * head_size
        self.qkv = nn.Linear(emb_size, 3 * inner)
        self.projection = nn.Linear(inner, emb_size)
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
                 forward_expansion: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(emb_size, eps=LN_EPS)
        self.mha = MultiHeadAttention(emb_size, num_heads, head_size)
        self.ln2 = nn.LayerNorm(emb_size, eps=LN_EPS)
        self.mlp1 = nn.Linear(emb_size, forward_expansion * emb_size)
        self.mlp2 = nn.Linear(forward_expansion * emb_size, emb_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mha(self.ln1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x))))


class ClassificationHead(nn.Module):
    """LN -> mean pool -> Linear -> Tanh -> Linear (``plainvit.py:542-557``)."""

    def __init__(self, emb_size: int, n_classes: int = 1000):
        super().__init__()
        self.ln = nn.LayerNorm(emb_size, eps=LN_EPS)
        self.linear1 = nn.Linear(emb_size, emb_size)
        self.linear2 = nn.Linear(emb_size, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.linear1(self.ln(x).mean(dim=1)))
        return self.linear2(x.to(torch.float32))  # float32 logits


class ViT(nn.Module):
    """ViT over (y, cbcr) DCT coefficients with the grouped embedding.

    ``forward(y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8))`` returns
    (B, n_classes) float32 logits.  Only ``pixel_space="dct"`` with
    ``ver=1`` is ported; the other embeddings raise ``NotImplementedError``.
    """

    def __init__(self, patch_size: int = 16, emb_size: int = 768, depth: int = 12,
                 num_heads: int = 8, head_size: int = 64, n_classes: int = 1000,
                 pixel_space: str = "DCT", ver: int = 1, use_subblock: bool = True):
        super().__init__()
        space = pixel_space.lower()
        if space == "rgb":
            raise NotImplementedError(
                "the RGB ViT is still to be ported (ROADMAP.md, port queue: RGB)")
        if space != "dct":
            raise ValueError(f"Unknown pixel space: {pixel_space}")
        if ver != 1:
            raise NotImplementedError(
                f"DCT embed_type {ver} is still to be ported (ROADMAP.md, port "
                "queue: other transfers and embeddings)")
        self.depth = depth
        self.patchembed = PatchEmbeddingDCTGroup(patch_size, emb_size, use_subblock)
        for i in range(depth):
            self.add_module(f"encoder_{i}", EncoderBlock(emb_size, num_heads, head_size))
        self.head = ClassificationHead(emb_size, n_classes)

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
        tokens = self.patchembed(y, cbcr)
        for i in range(self.depth):
            tokens = getattr(self, f"encoder_{i}")(tokens)
        return self.head(tokens)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, bias_init: str = "torch") -> None:
        """Draw every parameter from ``generator`` with the JAX package's
        init family: Linear weights and biases U(+-1/sqrt(fan_in)) (torch's
        default; ``bias_init="zeros"`` zeroes the biases), LayerNorm 1 and 0.
        """
        if bias_init not in ("torch", "zeros"):
            raise ValueError(f"unknown bias init family {bias_init!r}")
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if bias_init == "zeros":
                    m.bias.zero_()
                else:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
