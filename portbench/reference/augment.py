"""Plain reference of the input stage on DCT coefficients.

What the input stage does to a batch of coefficient planes (the wire
module's ``decode`` of its rows), written out in plain PyTorch: the
horizontal flip, the DCT RandAugment ops of the configurations' op lists at
a fixed magnitude, and the rescale to [-1, 1].  It follows the semantics of
the reference implementation's DCT ops (RGB-no-more, ``utils/dct_ops.py``
and ``utils/custom_transforms.py``) as the port states them, and imports
nothing of the port: it is the yardstick the port's input stage is held to.
"""

from __future__ import annotations

import numpy as np
import torch

DCT_MIN, DCT_MAX = -1024.0, 1016.0
NUM_BINS = 11  # magnitude bins of the RandAugment table

__all__ = ["DCT_MIN", "DCT_MAX", "apply_policy", "eval_stage", "magnitude",
           "train_stage"]


def to_range(x: torch.Tensor) -> torch.Tensor:
    """[DCT_MIN, DCT_MAX] -> [-1, 1]: normalise to [0, 1], then stretch."""
    span = torch.full((), DCT_MAX - DCT_MIN, dtype=torch.float32, device=x.device)
    return -1.0 + (x - DCT_MIN) / span * 2.0


def clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, DCT_MIN, DCT_MAX)


def _odd_sign(n: int, like: torch.Tensor) -> torch.Tensor:
    s = torch.ones(n, dtype=like.dtype, device=like.device)
    s[1::2] = -1.0
    return s


def hflip(x: torch.Tensor) -> torch.Tensor:
    """Mirror the block grid left-right and negate the odd horizontal
    frequencies of every block."""
    return torch.flip(x, dims=(-3,)) * _odd_sign(8, x)


def vflip_in_place(x: torch.Tensor) -> torch.Tensor:
    """Negate the odd vertical frequencies (no grid move)."""
    return x * _odd_sign(8, x)[:, None]


def rot90(x: torch.Tensor, ccw: bool) -> torch.Tensor:
    """Exact quarter turn of the image: the grid rotated, each block
    transposed and given the matching flip signs."""
    grid = (x.dim() - 4, x.dim() - 3)
    if ccw:
        return vflip_in_place(torch.rot90(x, 1, dims=grid).transpose(-2, -1))
    return torch.rot90(x, -1, dims=grid).transpose(-2, -1) * _odd_sign(8, x)


def magnitude(name: str, level: int, grid: int) -> float:
    """The op's magnitude at bin ``level`` of 11 (the reference's table)."""
    lin = np.linspace
    table = {
        "AutoContrast": lin(0, 0, NUM_BINS), "AutoSaturation": lin(0, 0, NUM_BINS),
        "Grayscale": lin(0, 0, NUM_BINS), "ChromaDrop": lin(0, 0, NUM_BINS),
        "Posterize": np.round(lin(0.0, 5.0, NUM_BINS)), "SolarizeAdd": lin(0, 883, NUM_BINS),
        "Color": lin(0.0, 0.9, NUM_BINS), "Contrast": lin(0.0, 0.9, NUM_BINS),
        "Brightness": lin(0.0, 0.9, NUM_BINS), "Sharpness": lin(0.0, 0.9, NUM_BINS),
        "MidfreqAug": lin(0.0, 0.9, NUM_BINS), "Cutout": lin(0, 6, NUM_BINS),
        "TranslateX": lin(0.0, 150.0 / 336.0 * grid, NUM_BINS),
        "TranslateY": lin(0.0, 150.0 / 336.0 * grid, NUM_BINS),
        "Rotate90": np.ones(NUM_BINS),
    }
    return float(table[name][level])


SIGNED = frozenset({"Color", "Contrast", "Brightness", "Sharpness", "MidfreqAug",
                    "TranslateX", "TranslateY", "Rotate90"})
CHROMA = frozenset({"Grayscale", "Color", "AutoSaturation", "ChromaDrop"})


def _dc_set(x: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[..., 0, 0] = dc
    return out


def _per(v: torch.Tensor, n_trailing: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * n_trailing)


def _autocontrast(x):
    dc = x[..., 0, 0]
    lo = dc.amin(dim=(-3, -2, -1), keepdim=True)
    hi = dc.amax(dim=(-3, -2, -1), keepdim=True)
    flat = hi == lo
    scaled = DCT_MIN + (dc - lo) / torch.where(flat, torch.ones_like(hi), hi - lo) * (
        DCT_MAX - DCT_MIN)
    return _dc_set(x, torch.where(flat, dc, scaled))


def _posterize(x, bits):
    step = 2.0 ** bits
    n = round((DCT_MAX - DCT_MIN) / step)
    idx = torch.round((x[..., 0, 0] - DCT_MIN) / step)
    return _dc_set(x, DCT_MIN + idx * (DCT_MAX - DCT_MIN) / max(n, 1.0))


def _ramp(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-sample sharpen / blur filter (n, 1, 1, 1, 8, 8)."""
    ar = torch.arange(8, dtype=torch.float32, device=like.device)
    r = torch.clamp(1.0 + 2.0 * t[:, None] * ar / 7.0, min=0.0)
    return (r[:, :, None] * r[:, None, :]).reshape(-1, 1, 1, 1, 8, 8)


def _midfreq(x, t):
    """Roll each block by half, multiply by a gaussian window (inverted to
    sharpen), clamp, roll back."""
    ar = torch.arange(8, dtype=torch.float32, device=x.device) - 3.5
    std = 4.0 - 2.2 * torch.abs(t)[:, None]
    g = torch.exp(-0.5 * torch.square(ar / std))
    filt = g[:, :, None] * g[:, None, :]
    filt = torch.where((t >= 0)[:, None, None], 1.0 / filt, filt).reshape(-1, 1, 1, 1, 8, 8)
    x = torch.roll(x, (4, 4), dims=(-2, -1))
    return torch.roll(clamp(x * filt), (4, 4), dims=(-2, -1))


def _translate(x, shift: int, axis: int):
    n = x.shape[axis]
    out = torch.roll(x, shift, dims=axis)
    idx = torch.arange(n, device=x.device)
    keep = idx >= shift if shift >= 0 else idx < n + shift
    shape = [1] * x.dim()
    shape[axis] = n
    return torch.where(keep.reshape(shape), out, torch.zeros((), device=x.device))


def _translate_blocks(mag: float) -> tuple[int, int]:
    """Shifts in blocks for sign +1 and -1: the sign applied before the value
    is made even by float modulo."""
    return int(mag - (mag % 2)), int(-mag - ((-mag) % 2))


def _cutout(x, half: int, ch, cw):
    h, w = x.shape[-4], x.shape[-3]
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    in_r = (rows >= ch[:, None] - half) & (rows < ch[:, None] + half)
    in_c = (cols >= cw[:, None] - half) & (cols < cw[:, None] + half)
    hole = (in_r[:, :, None] & in_c[:, None, :]).reshape(-1, 1, h, w, 1, 1)
    return torch.where(hole, torch.zeros((), device=x.device), x)


def _op(name: str, mag: float, y, c, sign, cut_ch, cut_cw, drop):
    """One op on its samples: y (n, 1, H, W, 8, 8), c (n, 2, H/2, W/2, 8, 8)."""
    m = mag * sign if name in SIGNED else torch.full_like(sign, mag)
    if name == "AutoContrast":
        y = _autocontrast(y)
    elif name == "AutoSaturation":
        c = _autocontrast(c)
    elif name == "Posterize":
        y, c = _posterize(y, mag), _posterize(c, mag)
    elif name == "SolarizeAdd":
        dc = y[..., 0, 0]
        y = clamp(_dc_set(y, torch.where(dc < 0.0, dc + int(mag), dc)))
    elif name == "Color":
        c = _dc_set(c, c[..., 0, 0] * _per(1.0 + m, 3))
    elif name == "Contrast":
        y = _dc_set(y, y[..., 0, 0] * _per(1.0 + m, 3))
    elif name == "Brightness":
        dc = y[..., 0, 0]
        mean_abs = dc.abs().mean(dim=(-3, -2, -1), keepdim=True)
        y = _dc_set(y, dc + mean_abs * (_per(1.0 + m, 3) - 1.0))
    elif name == "Sharpness":
        y = clamp(y * _ramp(m, y))
    elif name == "MidfreqAug":
        y = _midfreq(y, m)
    elif name == "Cutout":
        size = int(round(mag))
        size -= size % 2
        y = _cutout(y, size, cut_ch, cut_cw)
        c = _cutout(c, size // 2, cut_ch // 2, cut_cw // 2)
    elif name in ("TranslateX", "TranslateY"):
        pos, neg = _translate_blocks(mag)
        axis = -3 if name == "TranslateX" else -4
        sel = _per(sign > 0, 5)
        y = torch.where(sel, _translate(y, pos, axis), _translate(y, neg, axis))
        c = torch.where(sel, _translate(c, pos // 2, axis), _translate(c, neg // 2, axis))
    elif name == "Rotate90":
        sel = _per(sign > 0, 5)
        y = torch.where(sel, rot90(y, True), rot90(y, False))
        c = torch.where(sel, rot90(c, True), rot90(c, False))
    elif name == "Grayscale":
        c = c * 0.0
    elif name == "ChromaDrop":
        keep = torch.stack([~drop, drop], dim=1).to(c.dtype)  # drop set: keep Cr
        c = c * keep.reshape(-1, 2, 1, 1, 1, 1)
    else:
        raise ValueError(f"the reference has no DCT op {name!r}")
    return clamp(y), clamp(c)


def apply_policy(y, c, policy, ops_list, level: int):
    """Clamp, then each round runs every sample's drawn op (``policy`` =
    (idx, sign, cut_ch, cut_cw, drop), each (B, rounds))."""
    grid = y.shape[2]
    y, c = clamp(y), clamp(c)
    idx, sign, cut_ch, cut_cw, drop = (p.to(y.device) for p in policy)
    for r in range(idx.shape[1]):
        y_next, c_next = y.clone(), c.clone()
        for i, name in enumerate(ops_list):
            sel = (idx[:, r] == i).nonzero()[:, 0]
            if sel.numel():
                y_next[sel], c_next[sel] = _op(
                    name, magnitude(name, level, grid), y[sel], c[sel],
                    sign[sel, r].to(torch.float32), cut_ch[sel, r].to(torch.int64),
                    cut_cw[sel, r].to(torch.int64), drop[sel, r].to(torch.bool))
        y, c = y_next, c_next
    return y, c


def train_stage(y: torch.Tensor, c: torch.Tensor, flip, policy, ops_list, level: int):
    """Decoded planes -> (y, c): flip the samples whose bit is set,
    RandAugment, rescale."""
    sel = flip.to(y.device, torch.bool).reshape(-1, 1, 1, 1, 1, 1)
    y, c = torch.where(sel, hflip(y), y), torch.where(sel, hflip(c), c)
    y, c = apply_policy(y, c, policy, ops_list, level)
    return to_range(y), to_range(c)


def eval_stage(y: torch.Tensor, c: torch.Tensor):
    """Decoded planes -> (y, c): rescale."""
    return to_range(y), to_range(c)
