"""SwinV2 over JPEG DCT coefficients or RGB pixels (PyTorch).

Port of ``rgbnomore_tpu/models/swinv2.py`` (the reference's
``models/swinv2.py``, itself Microsoft's SwinV2) for both domains: cosine
window attention with a clamped learned logit scale, the continuous relative
position bias of a small MLP (CPB-MLP), shifted windows with an additive
mask, res-post-norm blocks whose norms start at zero scale, patch merging
between stages, and the grouped DCT patch embedding at patch 4 with a
LayerNorm and no sincos (``swinv2.py:505-576, 629-632``).  The RGB
convolution stem waits for the RGB slice of the port.

Every block's attention runs through ``ops.window_attention``: on the GPU
that is the hand-written CUDA kernel, 12 launches per SwinV2-T forward.  The
logit scale is folded into q before the call, as at the JAX package's
Pallas call site (``swinv2.py:175``).

Mixed precision follows the flax modules' dtype flow (``models/layers.py``):
the features are cast to ``dtype`` after the patch norm (``swinv2.py:385``);
each block's post-norm returns float32 and ``shortcut + drop_path(x)``
promotes, so the residual stream is float32 from the first block's output
on (``swinv2.py:259-296``); the qkv product promotes likewise (``x @
kernel.astype(dtype)``, ``:118-124``), so only the first block's q, k, v are
in ``dtype``; q and k are normalised in float32 and cast to ``dtype``
(``:137-140``); the window kernel takes float32 q times the logit scale, k
and v, and its output is cast back to ``dtype`` (the Pallas call site,
``:175-179``); the CPB-MLP and the head compute in float32.  Module and parameter names follow the
flax ones (``patch_embed``, ``layer{i}_block{d}/attn/{qkv, cpb_mlp1, ...}``,
``layer{i}_downsample``, ``norm``, ``head``) so that ``convert.py`` maps a
flax parameter tree onto ``state_dict`` keys one to one; ``qkv``,
``cpb_mlp1`` and ``cpb_mlp2`` are Linear layers, so the port's decay set
(Linear weights) is the JAX package's ``kernel_mask``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgbnomore_tpu_torch.models.embeddings import PatchEmbeddingDCTGroup
from rgbnomore_tpu_torch.models.layers import (
    Conv2d,
    Dropout,
    DropoutMasks,
    LayerNorm,
    Linear,
)
from rgbnomore_tpu_torch.ops.window_attention import window_attention

__all__ = ["DropPath", "PatchMerging", "SwinBlock", "SwinTransformerV2", "WindowAttention",
           "window_partition", "window_reverse"]

LN_EPS = 1e-5
# flax's truncated_normal draws from a normal cut at +-2 standard deviations
# and rescales it so that the cut distribution has the asked-for stddev
_TRUNC_STD = 0.87962566103423978


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C).  Reference: ``swinv2.py:38-50``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`.  Reference: ``swinv2.py:53-67``."""
    b = windows.shape[0] // ((h * w) // (ws * ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_coords_table(ws: int, pretrained_ws: int = 0) -> np.ndarray:
    """Log-spaced continuous relative coordinates, (2*ws-1, 2*ws-1, 2).

    Reference: ``swinv2.py:100-116``.
    """
    rel = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(rel, rel, indexing="ij"), axis=-1)
    denom = (pretrained_ws - 1) if pretrained_ws > 0 else (ws - 1)
    table = table / denom * 8.0
    return np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the flattened coords table (``swinv2.py:118-129``)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive (0 / -100) mask for shifted-window attention, (nW, N, N).

    Reference: ``swinv2.py:248-267``.
    """
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, ws_] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Cosine attention with CPB-MLP relative bias (``swinv2.py:70-182``).

    ``forward(windows (BW, N, C), mask (nW, N, N) | None)`` returns (BW, N,
    C) in ``dtype``.  ``attention`` is the function that computes ``softmax(QKᵀ + bias)
    V`` per window; it is ``window_attention`` (the CUDA kernels on the
    GPU), and a check may swap in ``ops.window_attention.
    window_attention_plain`` to hold the two against each other.
    """

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 pretrained_window_size: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.logit_scale = nn.Parameter(torch.log(10.0 * torch.ones(num_heads, 1, 1)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:  # q and v get a learnable bias, k does not
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.cpb_mlp1 = nn.Linear(2, 512)
        self.cpb_mlp2 = nn.Linear(512, num_heads, bias=False)
        self.proj = Linear(dim, dim, dtype=dtype)
        # float64 from numpy; float32 as JAX takes it (jnp.asarray without x64)
        table = _relative_coords_table(window_size, pretrained_window_size).astype(np.float32)
        self.register_buffer("coords_table", torch.from_numpy(table), persistent=False)
        index = _relative_position_index(window_size).reshape(-1).astype(np.int64)
        self.register_buffer("position_index", torch.from_numpy(index), persistent=False)
        self.attention = window_attention

    def position_bias(self) -> torch.Tensor:
        """``16 * sigmoid(CPB-MLP(coords))`` per head, (H, N, N)."""
        n = math.isqrt(self.position_index.numel())
        cpb = self.cpb_mlp2(F.relu(self.cpb_mlp1(self.coords_table)))
        cpb = cpb.reshape(-1, self.num_heads)[self.position_index].reshape(n, n, -1)
        return (16.0 * torch.sigmoid(cpb)).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        bw, n, c = x.shape
        dt = self.dtype
        # x @ kernel.astype(dtype) promotes: a float32 x keeps float32 (with
        # the kernel rounded to dtype), and so does the bias add
        out_dt = torch.promote_types(x.dtype, dt)
        qkv = F.linear(x.to(out_dt), self.qkv.weight.to(dt).to(out_dt))
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = qkv + bias.to(dt)
        qkv = qkv.reshape(bw, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()  # (bw, h, n, d)
        # cosine attention in float32: x / (|x| + 1e-12), not F.normalize's
        # clamp; the normalised q and k are rounded to dtype, then the
        # kernel takes them in float32
        q = (q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)).to(dt).float()
        k = (k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)).to(dt).float()
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)))
        bias = self.position_bias()[None]  # (1, H, N, N)
        if mask is not None:
            bias = bias + mask[:, None]  # (nW, H, N, N): window w uses w % nW
        out = self.attention((q * scale).contiguous(), k.contiguous(), v.contiguous(),
                             bias.contiguous())
        return self.proj(out.to(dt).transpose(1, 2).reshape(bw, n, c))


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics): in training, each
    sample's branch is kept with probability ``1 - rate`` and then scaled by
    ``1 / (1 - rate)``.  ``forward(x, keep)`` takes the (B,) bool keep mask
    that ``Trainer.draw`` drew; it is not read when the rate is 0 or in eval
    mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if keep is None:
            raise ValueError(f"drop path at rate {self.rate} in training needs the keep "
                             "mask of the step's draws")
        keep = keep.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class SwinBlock(nn.Module):
    """Res-post-norm SwinV2 block (``swinv2.py:202-309``).  A stage whose
    feature map is no larger than the window takes one unshifted window of
    the whole map."""

    def __init__(self, dim: int, input_resolution: tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, drop_path: float = 0.0,
                 pretrained_window_size: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        self.input_resolution, self.window_size, self.shift_size = (h, w), ws, shift
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, pretrained_window_size, dtype)
        mask = torch.from_numpy(_shift_attn_mask(h, w, ws, shift)) if shift > 0 else None
        self.register_buffer("attn_mask", mask, persistent=False)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.drop_path1 = DropPath(drop_path)
        hidden = int(dim * mlp_ratio)
        self.mlp1 = Linear(dim, hidden, dtype=dtype)
        self.mlp2 = Linear(hidden, dim, dtype=dtype)
        self.drop = Dropout(drop)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                dropout: DropoutMasks | None = None) -> torch.Tensor:
        """``keep``: (2, B) bool keep masks of the two drop-path branches;
        ``dropout``: the masks of the dropout after GELU and after mlp2."""
        h, w = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        b, l, c = x.shape
        shortcut = x
        x = x.reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x = window_reverse(self.attn(window_partition(x, ws), self.attn_mask), ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path1(self.norm1(x.reshape(b, l, c)),
                                       None if keep is None else keep[0])
        y = self.drop(F.gelu(self.mlp1(x)), dropout)
        y = self.norm2(self.drop(self.mlp2(y), dropout))
        return x + self.drop_path2(y, None if keep is None else keep[1])


class PatchMerging(nn.Module):
    """2x2 patch merging: 4C -> 2C reduction + norm (``swinv2.py:330-367``)."""

    def __init__(self, input_resolution: tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution = input_resolution
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)
        self.norm = LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.norm(self.reduction(x.reshape(b, (h // 2) * (w // 2), 4 * c)))


class SwinTransformerV2(nn.Module):
    """SwinV2 classifier over (y, cbcr) DCT coefficients or RGB pixels
    (``models/swinv2.py:578-712``).

    ``forward(y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8), drop_keep,
    dropout)`` (DCT) or ``forward(x (B, 3, H, W), drop_keep=...,
    dropout=...)`` (``pixel_space="rgb"``: the convolution stem
    ``patch_embed`` at ``patch_size``, then ``patch_norm``) returns (B, num_classes) float32 logits; ``drop_keep``
    (blocks, 2, B) bool holds the drop-path keep masks of a train step
    (``drop_path_rates`` gives each block's rate); in training at
    ``drop_rate > 0``, ``dropout`` gives the masks of the dropout after the
    patch embedding and, in each block, after GELU and after mlp2
    (``swinv2.py:286-290, 383-384``); ``dtype`` is the compute dtype of
    mixed precision (float32, bf16 or fp16).  ``ape`` adds the parameter
    ``absolute_pos_embed`` (1, L, C) to the patch embedding's tokens before
    its dropout (``swinv2.py:380-382``).  The DCT embedding's patch is
    always 4.
    """

    def __init__(self, img_size: int = 224, num_classes: int = 1000,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False, patch_norm: bool = True,
                 pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0),
                 pixel_space: str = "dct", dtype: torch.dtype = torch.float32,
                 patch_size: int = 4):
        super().__init__()
        space = pixel_space.lower()
        if space not in ("rgb", "dct"):
            raise ValueError(f"Unknown pixel space: {pixel_space}")
        self.dtype = dtype
        self.rgb = space == "rgb"
        if self.rgb:
            self.patch_embed = Conv2d(3, embed_dim, patch_size, dtype=dtype)
            self.patch_norm = LayerNorm(embed_dim, eps=LN_EPS) if patch_norm else None
            res = img_size // patch_size
        else:
            # grouped embedding at patch 4 (8x8 blocks -> 4x4 sub-blocks),
            # no sincos, with a post-projection norm (swinv2.py:629-632)
            self.patch_embed = PatchEmbeddingDCTGroup(4, embed_dim, use_subblock=True,
                                                      add_sincos=False, use_norm=patch_norm,
                                                      dtype=dtype)
            res = img_size // 4
        self.absolute_pos_embed = (nn.Parameter(torch.zeros(1, res * res, embed_dim))
                                   if ape else None)
        self.pos_drop = Dropout(drop_rate)
        self.depths = tuple(depths)
        self.drop_path_rates = np.linspace(0.0, drop_path_rate, sum(self.depths)).tolist()
        block = 0
        for i, depth in enumerate(self.depths):
            dim = int(embed_dim * 2 ** i)
            layer_res = (res // 2 ** i, res // 2 ** i)
            for d in range(depth):
                self.add_module(f"layer{i}_block{d}", SwinBlock(
                    dim, layer_res, num_heads[i], window_size,
                    0 if d % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias, drop_rate,
                    self.drop_path_rates[block], pretrained_window_sizes[i], dtype))
                block += 1
            if i < len(self.depths) - 1:
                self.add_module(f"layer{i}_downsample", PatchMerging(layer_res, dim, dtype))
        num_features = int(embed_dim * 2 ** (len(self.depths) - 1))
        self.norm = LayerNorm(num_features, eps=LN_EPS)
        self.head = nn.Linear(num_features, num_classes)

    def blocks(self) -> list[SwinBlock]:
        """The SwinV2 blocks in order."""
        return [getattr(self, f"layer{i}_block{d}")
                for i, depth in enumerate(self.depths) for d in range(depth)]

    def forward(self, y: torch.Tensor, cbcr: torch.Tensor | None = None,
                drop_keep: torch.Tensor | None = None,
                dropout: DropoutMasks | None = None) -> torch.Tensor:
        if self.rgb:  # (B, C, h, w) -> (B, h w, C), then the norm (float32)
            feats = self.patch_embed(y).flatten(2).transpose(1, 2)
            if self.patch_norm is not None:
                feats = self.patch_norm(feats)
        else:
            feats = self.patch_embed(y, cbcr)
        if self.absolute_pos_embed is not None:  # float32: the sum promotes
            feats = feats + self.absolute_pos_embed
        # dropped in the patch norm's float32, then cast (swinv2.py:383-385)
        feats = self.pos_drop(feats, dropout).to(self.dtype)
        block = 0
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                keep = None if drop_keep is None else drop_keep[block]
                feats = getattr(self, f"layer{i}_block{d}")(feats, keep, dropout)
                block += 1
            if i < len(self.depths) - 1:
                feats = getattr(self, f"layer{i}_downsample")(feats)
        feats = self.norm(feats).mean(dim=1)
        return self.head(feats.to(torch.float32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, bias_init: str = "torch") -> None:
        """Draw every parameter from ``generator`` with the JAX package's init
        family: truncated normal (std 0.02) for qkv, proj, the MLPs, patch
        merging, the head and the RGB stem's convolution, zero biases; LeCun
        truncated normal for the CPB-MLP; the DCT patch projection
        U(+-1/sqrt(fan_in)) (``bias_init="zeros"`` zeroes its bias); logit scale log 10; q and v biases 0; the
        blocks' res-post norms 0 and 0, every other LayerNorm 1 and 0; the
        absolute position embedding truncated normal (std 0.02)."""
        if bias_init not in ("torch", "zeros"):
            raise ValueError(f"unknown bias init family {bias_init!r}")

        def trunc_normal(t, std):
            s = std / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=generator)

        if self.absolute_pos_embed is not None:
            trunc_normal(self.absolute_pos_embed, 0.02)

        for name, m in self.named_modules():
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(m, nn.Conv2d):
                trunc_normal(m.weight, 0.02)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                if name == "patch_embed.projection":
                    bound = 1.0 / math.sqrt(m.in_features)
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if bias_init == "zeros":
                        m.bias.zero_()
                    else:
                        m.bias.uniform_(-bound, bound, generator=generator)
                    continue
                if leaf in ("cpb_mlp1", "cpb_mlp2"):
                    trunc_normal(m.weight, 1.0 / math.sqrt(m.in_features))
                else:
                    trunc_normal(m.weight, 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(0.0 if leaf in ("norm1", "norm2") else 1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                m.logit_scale.fill_(math.log(10.0))
                if m.q_bias is not None:
                    m.q_bias.zero_()
                    m.v_bias.zero_()
