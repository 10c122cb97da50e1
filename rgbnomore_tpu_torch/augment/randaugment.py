"""Batched RandAugment in the DCT domain (PyTorch).

Port of ``rgbnomore_tpu/augment/randaugment.py`` (the reference's
``utils/custom_transforms.py:944-1127``).  The policy — which op each sample
runs in each round, its sign, the cutout centre and the chroma channel that
ChromaDrop keeps — is drawn up front by :meth:`RandAugmentDCT.draw_policy`
from a ``torch.Generator``, and :meth:`RandAugmentDCT.apply` takes it
explicitly.  The fused kernel (``ops/augpipe.py``) consumes the same policy,
and the tests hand a JAX-drawn policy to both (the two frameworks' random
streams differ).

Fidelity notes, as in the JAX module:
- The magnitude table matches ``custom_transforms.py:1066-1092`` exactly,
  numpy's round-half-even in the Posterize row included.  Magnitudes are
  fixed by ``magnitude``; only the sign is random for signed ops.
- The grayscale/chroma exclusion rule (``:1111-1119``) is a per-sample
  allowed-mask updated between rounds; a list that exclusions emptied is
  reopened.
- Values stay float32; each op clamps to [-1024, 1016].

Only the 16 ops of the fused kernel's op set are ported; Equalize,
Solarize, Invert, FreqEnhance, Rotate, ShearX and ShearY raise
``NotImplementedError`` (ROADMAP.md, port queue: other transfers and
embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from rgbnomore_tpu_torch.ops import blocks
from rgbnomore_tpu_torch.ops import photometric as ph

__all__ = ["CHROMA_OPS", "RandAugmentDCT"]

CHROMA_OPS = frozenset({"Grayscale", "Color", "AutoSaturation", "ChromaDrop"})
_NOT_PORTED = frozenset({"Equalize", "Solarize", "Invert", "FreqEnhance", "Rotate",
                         "ShearX", "ShearY"})


def _magnitude_table(num_bins: int, grid_h: int, grid_w: int) -> dict[str, tuple[np.ndarray, bool]]:
    """op -> (magnitudes[num_bins], signed).  ``custom_transforms.py:1066-1092``."""
    lin = lambda a, b: np.linspace(a, b, num_bins)  # noqa: E731
    zero = np.zeros(num_bins)
    return {
        "Identity": (zero, False),
        "AutoContrast": (zero, False),
        "Equalize": (zero, False),
        "Invert": (zero, False),
        "Rotate": (lin(0.0, 30.0), True),
        "Posterize": (np.round(lin(0.0, 5.0)), False),
        "Solarize": (lin(818, -818), False),
        "SolarizeAdd": (lin(0, 883), False),
        "Color": (lin(0.0, 0.9), True),
        "Contrast": (lin(0.0, 0.9), True),
        "Brightness": (lin(0.0, 0.9), True),
        "Sharpness": (lin(0.0, 0.9), True),
        "ShearX": (lin(0.0, 17.0), True),
        "ShearY": (lin(0.0, 17.0), True),
        "Cutout": (lin(0, 6), False),
        "TranslateX": (lin(0.0, 150.0 / 336.0 * grid_w), True),
        "TranslateY": (lin(0.0, 150.0 / 336.0 * grid_h), True),
        "Rotate90": (np.ones(num_bins), True),
        "AutoSaturation": (zero, False),
        "Grayscale": (zero, False),
        "MidfreqAug": (lin(0.0, 0.9), True),
        "FreqEnhance": (lin(0.0, 0.9), True),
        "ChromaDrop": (zero, False),
    }


def translate_blocks(mag: float) -> tuple[int, int]:
    """Block shifts of a Translate op for sign +1 and -1.  The reference
    applies the sign BEFORE evenizing with float modulo
    (``custom_transforms.py:958``), so +3.75 -> +2 blocks but -3.75 -> -4."""
    return int(mag - (mag % 2)), int(-mag - ((-mag) % 2))


def cutout_size(mag: float) -> int:
    """Half-width in blocks of the luma cutout hole: round, then made even."""
    size = int(round(mag))
    return size - size % 2


def _clamp_pair(y, c):
    return ph.clamp_dct(y), ph.clamp_dct(c)


def _by_sign(sign: torch.Tensor, pos, neg):
    """Per sample: ``pos`` where sign > 0, else ``neg`` (both (n, ...))."""
    sel = (sign > 0).reshape((-1,) + (1,) * (pos.dim() - 1))
    return torch.where(sel, pos, neg)


def _make_op(name: str, mag: float, signed: bool) -> Callable:
    """Batched op ``(y, c, sign, cut_ch, cut_cw, drop) -> (y, c)``.

    ``y`` (n, 1, H, W, 8, 8), ``c`` (n, 2, H/2, W/2, 8, 8) float32; the draws
    are (n,) tensors, one per sample.  Semantics follow ``_apply_op_dct``
    (``custom_transforms.py:944-1021``) through the JAX ``_make_op``.
    """
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} op is still to be ported (ROADMAP.md, port queue: other "
            "transfers and embeddings)")

    def op(y, c, sign, cut_ch, cut_cw, drop):
        m = mag * sign if signed else mag
        if name == "Identity":
            return y, c
        if name in ("TranslateX", "TranslateY"):
            direction = "W" if name == "TranslateX" else "H"
            t_pos, t_neg = translate_blocks(mag)
            if t_pos == 0 and t_neg == 0:
                return y, c
            y2 = _by_sign(sign, ph.translate_dct(y, t_pos, direction),
                          ph.translate_dct(y, t_neg, direction))
            c2 = _by_sign(sign, ph.translate_dct(c, t_pos // 2, direction),
                          ph.translate_dct(c, t_neg // 2, direction))
            return _clamp_pair(y2, c2)
        if name == "Brightness":
            return _clamp_pair(ph.brightness_dct(y, 1.0 + m), c)
        if name == "Color":
            return _clamp_pair(y, ph.contrast_dct(c, 1.0 + m))
        if name == "Contrast":
            return _clamp_pair(ph.contrast_dct(y, 1.0 + m), c)
        if name == "Sharpness":
            return _clamp_pair(ph.sharpblur_dct(y, m), c)
        if name == "Posterize":
            return _clamp_pair(ph.posterize_dct(y, mag), ph.posterize_dct(c, mag))
        if name == "AutoContrast":
            return _clamp_pair(ph.autocontrast_dct(y), c)
        if name == "Cutout":
            size = cutout_size(mag)
            y2 = ph.cutout_dct(y, size, cut_ch, cut_cw)
            c2 = ph.cutout_dct(c, size // 2, cut_ch // 2, cut_cw // 2)
            return _clamp_pair(y2, c2)
        if name == "SolarizeAdd":
            return _clamp_pair(ph.solarize_add_dct(y, int(mag)), c)
        if name == "Rotate90":
            y2 = _by_sign(sign, blocks.rotate_dct_90deg(y, 1), blocks.rotate_dct_90deg(y, 3))
            c2 = _by_sign(sign, blocks.rotate_dct_90deg(c, 1), blocks.rotate_dct_90deg(c, 3))
            return _clamp_pair(y2, c2)
        if name == "AutoSaturation":
            return _clamp_pair(y, ph.autocontrast_dct(c))
        if name == "Grayscale":
            return _clamp_pair(y, c * 0.0)
        if name == "MidfreqAug":
            return _clamp_pair(ph.midfreqaug_dct(y, m), c)
        if name == "ChromaDrop":
            # drop set: keep channel 1 (Cr), else channel 0 (Cb)
            keep = torch.stack([~drop, drop], dim=1).to(c.dtype)
            return _clamp_pair(y, c * keep.reshape(-1, 2, 1, 1, 1, 1))
        raise ValueError(f"Unknown DCT augmentation op: {name}")

    return op


@dataclasses.dataclass
class RandAugmentDCT:
    """Batched DCT RandAugment policy.

    Args mirror the reference (``custom_transforms.py:1045-1064``):
    ``num_ops`` rounds per sample, a fixed ``magnitude`` index into the
    11-bin table, an op list.  (The JAX class's ``pad`` serves Rotate and
    Shear, which are not ported.)
    """

    ops_list: list[str]
    num_ops: int = 2
    magnitude: int = 3
    num_magnitude_bins: int = 11
    grid: int = 28

    def __post_init__(self):
        table = _magnitude_table(self.num_magnitude_bins, self.grid, self.grid)
        unknown = [o for o in self.ops_list if o not in table]
        if unknown:
            raise ValueError(f"Unknown ops: {unknown}")
        self._ops = []
        for name in self.ops_list:
            mags, signed = table[name]
            self._ops.append(_make_op(name, float(mags[self.magnitude]), signed))
        self._signed = torch.tensor([table[o][1] for o in self.ops_list], dtype=torch.bool)
        self._is_chroma = torch.tensor([o in CHROMA_OPS for o in self.ops_list],
                                       dtype=torch.bool)
        self._is_gray = torch.tensor([o == "Grayscale" for o in self.ops_list],
                                     dtype=torch.bool)

    def draw_policy(self, generator: torch.Generator, batch: int, h: int, w: int):
        """Batch policy draws ``(idx, sign, cut_ch, cut_cw, drop)``, each
        ``(batch, num_ops)`` on the generator's device: the op index
        (int32), its sign (float32, -1 only for signed ops), the even cutout
        centre in blocks (int32) and ChromaDrop's channel bit (bool)."""
        dev = generator.device
        n = len(self.ops_list)
        signed = self._signed.to(dev)
        is_chroma = self._is_chroma.to(dev)
        is_gray = self._is_gray.to(dev)
        allowed = torch.ones((batch, n), dtype=torch.bool, device=dev)
        outs = []
        for _ in range(self.num_ops):
            # if exclusions emptied the list (all-chroma lists), reopen it
            allowed = allowed | ~allowed.any(dim=1, keepdim=True)
            idx = torch.multinomial(allowed.to(torch.float32), 1, generator=generator)[:, 0]
            flip_sign = torch.rand(batch, generator=generator, device=dev) < 0.5
            sign = torch.where(flip_sign & signed[idx], -1.0, 1.0)
            cut_ch = torch.randint(0, h, (batch,), generator=generator, device=dev) // 2 * 2
            cut_cw = torch.randint(0, w, (batch,), generator=generator, device=dev) // 2 * 2
            drop = torch.rand(batch, generator=generator, device=dev) < 0.5
            # exclusion rule: grayscale disables chroma ops and vice versa
            chose_gray = is_gray[idx]
            chose_chroma = is_chroma[idx] & ~chose_gray
            allowed = torch.where(chose_gray[:, None], allowed & ~is_chroma, allowed)
            allowed = torch.where(chose_chroma[:, None], allowed & ~is_gray, allowed)
            outs.append((idx.to(torch.int32), sign, cut_ch.to(torch.int32),
                         cut_cw.to(torch.int32), drop))
        return tuple(torch.stack(col, dim=1) for col in zip(*outs))

    def apply(self, y: torch.Tensor, cbcr: torch.Tensor, policy):
        """Apply ``policy`` (the ``draw_policy`` tuple) to a batch
        y (B, 1, H, W, 8, 8), cbcr (B, 2, H/2, W/2, 8, 8): clamp, then each
        round runs every sample's drawn op.  A round groups the samples by
        op and runs each op once on its group."""
        y, cbcr = _clamp_pair(y, cbcr)
        if not self.ops_list:
            return y, cbcr
        idx, sign, cut_ch, cut_cw, drop = (torch.as_tensor(p).to(y.device) for p in policy)
        drop = drop.to(torch.bool)
        for r in range(idx.shape[1]):
            y_next, c_next = y.clone(), cbcr.clone()
            for i, op in enumerate(self._ops):
                sel = (idx[:, r] == i).nonzero()[:, 0]
                if sel.numel() == 0:
                    continue
                y_next[sel], c_next[sel] = op(y[sel], cbcr[sel], sign[sel, r],
                                              cut_ch[sel, r], cut_cw[sel, r], drop[sel, r])
            y, cbcr = y_next, c_next
        return y, cbcr
