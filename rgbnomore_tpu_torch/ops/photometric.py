"""Photometric DCT-domain augmentation primitives (PyTorch).

Port of ``rgbnomore_tpu/ops/photometric.py``: the ops that the fused
augmentation kernel's op set needs.  Each function takes coefficients laid
out ``(..., C, H, W, 8, 8)`` in float32: one sample ``(C, H, W, 8, 8)`` or a
batch with leading axes.  Reductions (mean / min / max of the DC plane) run
per sample over its ``(C, H, W)`` DCs, as the reference does per image.  A
magnitude may be a Python number or a tensor of the leading (sample) shape,
so a batch can carry one magnitude per sample.

Semantics mirror ``utils/dct_ops.py`` of the reference (cited per function
in the JAX module).  Equalize, Solarize, Invert and FreqEnhance are still to
be ported (ROADMAP.md, port queue: other transfers and embeddings).
"""

from __future__ import annotations

import torch

DCT_MIN = -1024.0  # -2**10
DCT_MAX = 1016.0  # 2**10 - 8

__all__ = [
    "DCT_MIN",
    "DCT_MAX",
    "clamp_dct",
    "solarize_add_dct",
    "sharpblur_dct",
    "midfreqaug_dct",
    "translate_dct",
    "cutout_dct",
    "brightness_dct",
    "contrast_dct",
    "autocontrast_dct",
    "posterize_dct",
]

_DC_AXES = (-3, -2, -1)  # (C, H, W) of the DC plane


def _per_sample(value, lead: torch.Size, trailing: int, like: torch.Tensor):
    """``value`` (a number, or a tensor of the leading shape ``lead``) as a
    float32 tensor that broadcasts over ``trailing`` more axes."""
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    if t.dim() == 0:
        return t
    if t.shape != lead:
        raise ValueError(f"per-sample magnitude of shape {tuple(t.shape)}, want {tuple(lead)}")
    return t.reshape(tuple(lead) + (1,) * trailing)


def clamp_dct(coeff: torch.Tensor) -> torch.Tensor:
    """Clamp to the 8-bit dequantized DCT range ``[-1024, 1016]``."""
    return torch.clamp(coeff, DCT_MIN, DCT_MAX)


def _set_dc(coeff: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    out = coeff.clone()
    out[..., 0, 0] = dc
    return out


def solarize_add_dct(coeff: torch.Tensor, addition, threshold: float = 0.0) -> torch.Tensor:
    """Add ``addition`` to DCs below ``threshold``; clamp."""
    dc = coeff[..., 0, 0]
    return clamp_dct(_set_dc(coeff, torch.where(dc < threshold, dc + addition, dc)))


def sharpblur_dct(coeff: torch.Tensor, intensity) -> torch.Tensor:
    """Sharpen (>0) / blur (<0) via a linear high-frequency ramp:
    ``clamp(linspace(1, 1+2*intensity, 8), 0)`` outer product over the 8x8
    frequency axes."""
    lead = coeff.shape[:-5]
    kh, kw = coeff.shape[-2], coeff.shape[-1]
    t = _per_sample(intensity, lead, 1, coeff)  # (..., 1)
    ar_h = torch.arange(kh, dtype=torch.float32, device=coeff.device)
    ar_w = torch.arange(kw, dtype=torch.float32, device=coeff.device)
    ramp_h = torch.clamp(1.0 + 2.0 * t * ar_h / (kh - 1), min=0.0)
    ramp_w = torch.clamp(1.0 + 2.0 * t * ar_w / (kw - 1), min=0.0)
    filt = ramp_h[..., :, None] * ramp_w[..., None, :]  # (..., 8, 8)
    filt = filt.reshape(filt.shape[:-2] + (1, 1, 1) + filt.shape[-2:])
    return clamp_dct(coeff * filt)


def _gaussian_window(n: int, std: torch.Tensor) -> torch.Tensor:
    """exp(-0.5*((i-(n-1)/2)/std)^2) over the last axis; ``std`` (..., 1)."""
    i = torch.arange(n, dtype=torch.float32, device=std.device) - (n - 1) / 2.0
    return torch.exp(-0.5 * torch.square(i / std))


def midfreqaug_dct(coeff: torch.Tensor, intensity) -> torch.Tensor:
    """Mid-frequency sharpen/blur with a (block-shifted) gaussian window."""
    lead = coeff.shape[:-5]
    kh, kw = coeff.shape[-2], coeff.shape[-1]
    t = _per_sample(intensity, lead, 1, coeff)  # (..., 1)
    x = torch.roll(coeff, (kh // 2, kw // 2), dims=(-2, -1))  # blockshift
    std_h = kh // 2 - (kh // 8 * 2.2) * torch.abs(t)
    std_w = kw // 2 - (kw // 8 * 2.2) * torch.abs(t)
    filt = _gaussian_window(kh, std_h)[..., :, None] * _gaussian_window(kw, std_w)[..., None, :]
    filt = torch.where(t[..., None] >= 0, 1.0 / filt, filt)
    filt = filt.reshape(filt.shape[:-2] + (1, 1, 1) + filt.shape[-2:])
    x = clamp_dct(x * filt)
    return torch.roll(x, (kh - kh // 2, kw - kw // 2), dims=(-2, -1))  # iblockshift


def translate_dct(coeff: torch.Tensor, magnitude: int, direction: str = "H") -> torch.Tensor:
    """Translate by ``magnitude`` blocks along H or W, zero-filling the gap."""
    axis = coeff.dim() - 4 if direction == "H" else coeff.dim() - 3
    n = coeff.shape[axis]
    mag = int(magnitude)
    out = torch.roll(coeff, mag, dims=axis)
    idx = torch.arange(n, device=coeff.device)
    keep = idx >= mag if mag >= 0 else idx < n + mag
    shape = [1] * coeff.dim()
    shape[axis] = n
    return torch.where(keep.reshape(shape), out, torch.zeros((), dtype=coeff.dtype,
                                                             device=coeff.device))


def cutout_dct(coeff: torch.Tensor, pad_size: int, center_h, center_w) -> torch.Tensor:
    """Zero a ``2*pad_size`` square of blocks centred at ``(center_h,
    center_w)``, each a number or one per sample."""
    lead = coeff.shape[:-5]
    h, w = coeff.shape[-4], coeff.shape[-3]

    def centre(value):
        t = torch.as_tensor(value, device=coeff.device)
        return t.reshape(tuple(lead) + (1,)) if t.dim() else t

    ch, cw = centre(center_h), centre(center_w)
    rows = torch.arange(h, device=coeff.device)
    cols = torch.arange(w, device=coeff.device)
    in_rows = (rows >= ch - pad_size) & (rows < ch + pad_size)  # (..., H)
    in_cols = (cols >= cw - pad_size) & (cols < cw + pad_size)  # (..., W)
    mask = in_rows[..., :, None] & in_cols[..., None, :]  # (..., H, W)
    mask = mask.reshape(mask.shape[:-2] + (1,) + mask.shape[-2:] + (1, 1))
    return torch.where(mask, torch.zeros((), dtype=coeff.dtype, device=coeff.device), coeff)


def brightness_dct(coeff: torch.Tensor, factor) -> torch.Tensor:
    """DC += mean(|DC|) * (factor - 1), the mean per sample."""
    dc = coeff[..., 0, 0]
    f = _per_sample(factor, coeff.shape[:-5], 3, coeff)
    mean_abs = torch.mean(torch.abs(dc), dim=_DC_AXES, keepdim=True)
    return _set_dc(coeff, dc + mean_abs * (f - 1.0))


def contrast_dct(coeff: torch.Tensor, factor) -> torch.Tensor:
    """DC *= factor; doubles as saturation on chroma."""
    f = _per_sample(factor, coeff.shape[:-5], 3, coeff)
    return _set_dc(coeff, coeff[..., 0, 0] * f)


def autocontrast_dct(coeff: torch.Tensor) -> torch.Tensor:
    """Rescale DCs so min -> DCT_MIN and max -> DCT_MAX, per sample and joint
    over its channels."""
    dc = coeff[..., 0, 0]
    dc_min = torch.amin(dc, dim=_DC_AXES, keepdim=True)
    dc_max = torch.amax(dc, dim=_DC_AXES, keepdim=True)
    flat = dc_max == dc_min
    scale = (dc - dc_min) / torch.where(flat, torch.ones_like(dc_max), dc_max - dc_min)
    rescaled = DCT_MIN + scale * (DCT_MAX - DCT_MIN)
    return _set_dc(coeff, torch.where(flat, dc, rescaled))


def posterize_dct(coeff: torch.Tensor, bitoffset) -> torch.Tensor:
    """Quantize DCs by dropping ``bitoffset`` bits: the reference's lookup
    table in closed form, ``lo + round((dc-lo)/2^b) * (hi-lo)/N`` with
    ``N = round((hi-lo)/2^b)`` (rounding half to even), over the clamp range
    [lo, hi] = [DCT_MIN, DCT_MAX]."""
    lo, hi = DCT_MIN, DCT_MAX
    step = torch.exp2(torch.as_tensor(bitoffset, dtype=torch.float32, device=coeff.device))
    n = torch.round((hi - lo) / step)
    idx = torch.round((coeff[..., 0, 0] - lo) / step)
    return _set_dc(coeff, lo + idx * (hi - lo) / torch.clamp(n, min=1.0))
