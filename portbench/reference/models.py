"""Plain float32 references of the benchmark's models, in plain PyTorch.

- :class:`ViT`: ViT-S/16 as DeiT-S (arXiv:2012.12877) over JPEG DCT
  coefficients with the separate sub-block embedding of RGB-no-more
  (arXiv:2211.16421, ``models/plainvit.py:280-351``, ``:412-612``): the
  patch's luma and chroma coefficients on the 16x16 DCT basis, projected
  apart, GELU, a mixing Linear with a residual, sincos; pre-LN blocks whose
  attention logits are scaled by ``1/sqrt(emb_size)`` (the reference's quirk);
  head LN -> mean -> Linear -> tanh -> Linear.
- :class:`SwinV2`: SwinV2-T (arXiv:2111.09883) over DCT coefficients:
  the grouped embedding at patch 4 with a LayerNorm, cosine window attention
  with a clamped logit scale and the CPB-MLP bias, shifted windows with a
  -100 mask, res-post-norm blocks, patch merging, per-sample drop path.

Parameter names are those of the port's ``state_dict``, so the benchmark
loads one set of weights into both.  Every product is plain float32 with
TF32 off.  ``Precision`` rounds the operands of each product; the
benchmark's control puts a lower precision there.  Nothing here imports the
port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MODELED", "Precision", "SwinV2", "ViT", "build", "check_model", "set_precision"]


def _keep_grad(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` forward, the gradient of ``x`` backward."""
    return x + (rounded - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, to nearest)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to fp8 e4m3 under one scale for the tensor (its absolute
    maximum onto e4m3's 448)."""
    x = x.detach().float()
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Precision:
    """Operand rounding of every product: ``"float32"`` (none), ``"tf32"``
    or ``"fp8"``."""

    ROUND = {"float32": None, "tf32": round_tf32, "fp8": round_fp8}

    def __init__(self, name: str = "float32"):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name, self._round = name, self.ROUND[name]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._round is None else _keep_grad(x, self._round(x))


FLOAT32 = Precision()


class Linear(nn.Linear):
    """A Linear whose operands pass through the model's ``Precision``."""

    prec = FLOAT32

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


def set_precision(model: nn.Module, prec: Precision) -> None:
    for m in model.modules():
        if hasattr(m, "prec"):
            m.prec = prec


def _mm(prec, eq, a, b):
    return torch.einsum(eq, prec(a), prec(b))


# ------------------------------------------------------------------ DCT basis
def _dct_basis(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :] + 0.5
    basis = np.cos(k * i * np.pi / n)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return (basis * math.sqrt(2.0 / n)).astype(np.float32)


def conversion_matrix(small: int, mult: int) -> np.ndarray:
    """Projection of ``mult`` stacked ``small``-point DCT blocks onto one
    ``small * mult``-point DCT basis (orthonormal)."""
    if mult == 1:
        return np.eye(small, dtype=np.float32)
    big = _dct_basis(small * mult).astype(np.float64)
    blocks = np.zeros((small * mult,) * 2)
    for m in range(mult):
        blocks[m * small:(m + 1) * small, m * small:(m + 1) * small] = _dct_basis(small)
    return (big @ blocks.T).astype(np.float32)


def combine(x: torch.Tensor, pd: int, conv: torch.Tensor | None) -> torch.Tensor:
    """(B, C, H*pd, W*pd, k, k) blocks -> (B, C, H, W, pd*k, pd*k) patches on
    the larger basis."""
    b, c, hp, wp, k1, k2 = x.shape
    x = x.reshape(b, c, hp // pd, pd, wp // pd, pd, k1, k2).permute(0, 1, 2, 4, 3, 6, 5, 7)
    x = x.reshape(b, c, hp // pd, wp // pd, pd * k1, pd * k2)
    return x if conv is None else conv @ x @ conv.T


def split(x: torch.Tensor, pd: int, conv: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W, 8, 8) -> (B, C, H*pd, W*pd, 8/pd, 8/pd) sub-blocks."""
    x = conv.T @ x @ conv
    b, c, h, w, k1, k2 = x.shape
    x = x.reshape(b, c, h, w, k1 // pd, pd, k2 // pd, pd).permute(0, 1, 2, 5, 3, 7, 4, 6)
    return x.reshape(b, c, h * pd, w * pd, k1 // pd, k2 // pd)


def patches(x: torch.Tensor, patch: int, conv_cache: dict) -> torch.Tensor:
    """8x8 blocks as ``patch``-point DCT patches, channels last: (B, h, w, C*p*p)."""
    if patch >= 8:
        pd = patch // 8
        conv = None if pd == 1 else conv_cache.setdefault(
            ("c", pd, x.device), torch.from_numpy(conversion_matrix(8, pd)).to(x.device))
        x = combine(x, pd, conv)
    else:
        pd = 8 // patch
        conv = conv_cache.setdefault(("s", patch, x.device),
                                     torch.from_numpy(conversion_matrix(patch, pd)).to(x.device))
        x = split(x, pd, conv)
    b, _, h, w = x.shape[:4]
    return x.permute(0, 2, 3, 1, 4, 5).reshape(b, h, w, -1)


def sincos(h: int, w: int, e: int, device) -> torch.Tensor:
    """2-D sin-cos position embedding (h, w, e): sin(w), cos(w), sin(h), cos(h)."""
    nf = e // 4
    step = torch.tensor(math.log(10000.0) / (nf - 1), device=device)
    freqs = torch.exp(-torch.arange(nf, dtype=torch.float32, device=device) * step)
    hh, ww = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    ph = hh.reshape(-1)[:, None] * freqs
    pw = ww.reshape(-1)[:, None] * freqs
    return torch.cat([pw.sin(), pw.cos(), ph.sin(), ph.cos()], dim=-1).reshape(h, w, e)


# ------------------------------------------------------------------ ViT
class _EmbedSeparateSubblock(nn.Module):
    def __init__(self, patch: int, emb: int):
        super().__init__()
        self.patch = patch
        self.projection_y = Linear(patch ** 2, emb // 6 * 4)
        self.projection_c = Linear(2 * (patch // 2) ** 2, emb // 6 * 2)
        self.linear_mix = Linear(emb, emb)
        self._conv: dict = {}

    def forward(self, y, c):
        y = patches(y, self.patch, self._conv)
        c = patches(c, self.patch // 2, self._conv)
        feats = F.gelu(torch.cat([self.projection_y(y), self.projection_c(c)], dim=-1))
        feats = self.linear_mix(feats) + feats
        h, w, e = feats.shape[1:]
        return (feats + sincos(h, w, e, feats.device)).flatten(1, 2)


class _Attention(nn.Module):
    prec = FLOAT32

    def __init__(self, emb: int, heads: int, head_size: int):
        super().__init__()
        self.heads, self.head_size, self.scale = heads, head_size, 1.0 / math.sqrt(emb)
        self.qkv = Linear(emb, 3 * heads * head_size)
        self.projection = Linear(heads * head_size, emb)

    def forward(self, x):
        b, n, _ = x.shape
        inner = self.heads * self.head_size
        q, k, v = (t.reshape(b, n, self.heads, self.head_size).transpose(1, 2)
                   for t in self.qkv(x).split(inner, dim=-1))
        att = torch.softmax(_mm(self.prec, "bhqd,bhkd->bhqk", q, k) * self.scale, dim=-1)
        out = _mm(self.prec, "bhqk,bhkd->bhqd", att, v)
        return self.projection(out.transpose(1, 2).reshape(b, n, inner))


class _Encoder(nn.Module):
    def __init__(self, emb: int, heads: int, head_size: int, mlp: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(emb, eps=1e-5)
        self.mha = _Attention(emb, heads, head_size)
        self.ln2 = nn.LayerNorm(emb, eps=1e-5)
        self.mlp1 = Linear(emb, mlp * emb)
        self.mlp2 = Linear(mlp * emb, emb)

    def forward(self, x):
        x = x + self.mha(self.ln1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x))))


class _Head(nn.Module):
    def __init__(self, emb: int, classes: int):
        super().__init__()
        self.ln = nn.LayerNorm(emb, eps=1e-5)
        self.linear1 = Linear(emb, emb)
        self.linear2 = Linear(emb, classes)

    def forward(self, x):
        return self.linear2(torch.tanh(self.linear1(self.ln(x).mean(dim=1))))


class ViT(nn.Module):
    """``forward(y, c) -> (B, classes)`` logits; embedding version 2 with
    sub-blocks."""

    def __init__(self, m: dict):
        super().__init__()
        if m["version"] != 2 or not m["subblock"]:
            raise ValueError("the reference ViT has the separate sub-block embedding only")
        emb, self.depth = m["embed_size"], m["depth"]
        self.patchembed = _EmbedSeparateSubblock(m["patch_size"], emb)
        for i in range(self.depth):
            self.add_module(f"encoder_{i}", _Encoder(emb, m["heads"], m["head_size"],
                                                     m["mlp_ratio"]))
        self.head = _Head(emb, m["classes"])

    def forward(self, y, c, drop_keep=None):
        x = self.patchembed(y, c)
        for i in range(self.depth):
            x = getattr(self, f"encoder_{i}")(x)
        return self.head(x)


# ------------------------------------------------------------------ SwinV2
def _partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(win, ws, h, w):
    b = win.shape[0] // ((h * w) // (ws * ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _coords_table(ws: int) -> torch.Tensor:
    rel = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(rel, rel, indexing="ij"), axis=-1) / (ws - 1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return torch.from_numpy(t.astype(np.float32))


def _position_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1).reshape(-1).astype(np.int64))


def _shift_mask(h, w, ws, shift) -> torch.Tensor:
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    m = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.from_numpy(np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)
                            .astype(np.float32))


class _WindowAttention(nn.Module):
    prec = FLOAT32

    def __init__(self, dim: int, ws: int, heads: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.logit_scale = nn.Parameter(torch.zeros(heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.cpb_mlp1 = Linear(2, 512)
        self.cpb_mlp2 = Linear(512, heads, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask):
        bw, n, c = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = (self.qkv(x) + bias).reshape(bw, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        table = _coords_table(self.ws).to(x.device)
        cpb = self.cpb_mlp2(F.relu(self.cpb_mlp1(table))).reshape(-1, self.heads)
        cpb = cpb[_position_index(self.ws).to(x.device)].reshape(n, n, -1).permute(2, 0, 1)
        logits = _mm(self.prec, "whqd,whkd->whqk", q * scale, k) + 16.0 * torch.sigmoid(cpb)
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(bw // nw, nw, self.heads, n, n) + mask[:, None]
                      ).reshape(bw, self.heads, n, n)
        out = _mm(self.prec, "whqk,whkd->whqd", torch.softmax(logits, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class _SwinBlock(nn.Module):
    def __init__(self, dim, res, heads, ws, shift, mlp, rate):
        super().__init__()
        if res <= ws:
            ws, shift = res, 0
        self.res, self.ws, self.shift, self.rate = res, ws, shift, rate
        self.attn = _WindowAttention(dim, ws, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp1 = Linear(dim, mlp * dim)
        self.mlp2 = Linear(mlp * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def _drop(self, x, keep):
        if keep is None or self.rate == 0.0:
            return x
        return torch.where(keep.reshape(-1, 1, 1), x / (1.0 - self.rate), 0.0)

    def forward(self, x, keep):
        b, l, c = x.shape
        h = self.res
        t = x.reshape(b, h, h, c)
        mask = None
        if self.shift:
            t = torch.roll(t, (-self.shift, -self.shift), dims=(1, 2))
            mask = _shift_mask(h, h, self.ws, self.shift).to(x.device)
        t = _reverse(self.attn(_partition(t, self.ws), mask), self.ws, h, h)
        if self.shift:
            t = torch.roll(t, (self.shift, self.shift), dims=(1, 2))
        x = x + self._drop(self.norm1(t.reshape(b, l, c)), None if keep is None else keep[0])
        y = self.norm2(self.mlp2(F.gelu(self.mlp1(x))))
        return x + self._drop(y, None if keep is None else keep[1])


class _Merge(nn.Module):
    def __init__(self, res, dim):
        super().__init__()
        self.res = res
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x):
        b, _, c = x.shape
        h = self.res
        x = x.reshape(b, h, h, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.norm(self.reduction(x.reshape(b, (h // 2) ** 2, 4 * c)))


class _EmbedGroup(nn.Module):
    """Grouped DCT embedding at patch 4: luma 4x4 sub-blocks and chroma 2x2
    ones of each patch, one Linear, a LayerNorm."""

    def __init__(self, emb: int):
        super().__init__()
        self.projection = Linear(16 + 2 * 4, emb)
        self.norm = nn.LayerNorm(emb, eps=1e-5)
        self._conv: dict = {}

    def forward(self, y, c):
        feats = self.projection(torch.cat([patches(y, 4, self._conv),
                                           patches(c, 2, self._conv)], dim=-1))
        return self.norm(feats.flatten(1, 2))


class SwinV2(nn.Module):
    """``forward(y, c, drop_keep (blocks, 2, B) | None) -> logits``."""

    def __init__(self, m: dict):
        super().__init__()
        emb, depths, heads, ws = m["embed_size"], m["depth"], m["heads"], m["window_size"]
        self.depths = tuple(depths)
        self.drop_path_rates = np.linspace(0.0, m["drop_path"], sum(depths)).tolist()
        self.patch_embed = _EmbedGroup(emb)
        res = m["dct_blocks"] * 8 // 4
        block = 0
        for i, depth in enumerate(depths):
            dim, r = emb * 2 ** i, res // 2 ** i
            for d in range(depth):
                self.add_module(f"layer{i}_block{d}", _SwinBlock(
                    dim, r, heads[i], ws, 0 if d % 2 == 0 else ws // 2, m["mlp_ratio"],
                    self.drop_path_rates[block]))
                block += 1
            if i < len(depths) - 1:
                self.add_module(f"layer{i}_downsample", _Merge(r, dim))
        feats = emb * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(feats, eps=1e-5)
        self.head = Linear(feats, m["classes"])

    def forward(self, y, c, drop_keep=None):
        x = self.patch_embed(y, c)
        block = 0
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                keep = None if drop_keep is None else drop_keep[block]
                x = getattr(self, f"layer{i}_block{d}")(x, keep)
                block += 1
            if i < len(self.depths) - 1:
                x = getattr(self, f"layer{i}_downsample")(x)
        return self.head(self.norm(x).mean(dim=1))


# Per architecture, every key of a configuration's ``model`` section that the
# reference models: None where it reads any value, else the values it has.
_ANY = None
MODELED = {
    "vit": {"arch": {"vitti", "vits", "vitb", "vitl"}, "domain": {"DCT"}, "version": {2},
            "subblock": {True}, "patch_size": {16}, "embed_size": _ANY, "depth": _ANY,
            "heads": _ANY, "head_size": _ANY, "mlp_ratio": _ANY, "classes": _ANY,
            "dct_blocks": _ANY, "input_size": _ANY},
    "swinv2": {"arch": {"swinv2"}, "domain": {"DCT"}, "patch_size": {4}, "embed_size": _ANY,
               "depth": _ANY, "heads": _ANY, "window_size": _ANY, "mlp_ratio": _ANY,
               "drop_path": _ANY, "qkv_bias": {True}, "ape": {False}, "patch_norm": {True},
               "classes": _ANY, "dct_blocks": _ANY, "input_size": _ANY, "amp_dtype": _ANY},
}


def check_model(model: dict) -> str:
    """The reference's family for a ``model`` section (``vit`` or
    ``swinv2``); raise where the section names a key or a value that the
    reference does not model."""
    family = "swinv2" if model["arch"] == "swinv2" else "vit"
    modeled = MODELED[family]
    unknown = sorted(set(model) - set(modeled))
    if unknown:
        raise ValueError(f"the reference {family} does not model the keys {unknown}")
    for key, allowed in modeled.items():
        if key not in model:
            raise ValueError(f"the reference {family} needs the key {key!r}")
        if allowed is not None and model[key] not in allowed:
            raise ValueError(f"the reference {family} models {key} in {sorted(allowed)}, "
                             f"not {model[key]!r}")
    if model["input_size"] != 8 * model["dct_blocks"]:
        raise ValueError("input_size has to be 8 x dct_blocks")
    return family


def build(model: dict, device=None) -> nn.Module:
    """The reference model of a configuration's ``model`` section."""
    cls = SwinV2 if check_model(model) == "swinv2" else ViT
    with torch.device(device or "cpu"):
        return cls(model)
