"""Batched random-resized crop, center crop and whole-image resize of DCT
coefficient canvases, as products with stacked resize operators.

Port of ``rgbnomore_tpu/augment/crops.py`` (the reference's per-sample crop
and resize, ``utils/custom_transforms.py:527-669``, ``:819-911``).  Per axis,
a crop followed by the reference's gcd-based resize is a linear map from the
canvas's coefficients to the target's: for each crop size ``s`` the dense
operator ``R(s -> target)`` (``ops.basis.resize_axis_operator``) is built
once, and the crop's offset shifts where it sits inside a ``(target*8,
canvas*8)`` matrix.  The batched crop + resize is two batched products,

    out[b] = M_h[b] @ Y_flat[b] @ M_w[b]^T,

with the per-sample matrices gathered from the stack.  These products live
outside any Pallas kernel in the JAX package (XLA einsums at HIGHEST
precision), so here they are ``torch.matmul`` in float32.

The crop boxes follow the reference's distribution (aspect ratio 1:1 as the
DCT pipelines use): ``area ~ U(scale) * canvas^2``, side ``round(sqrt(area))``
snapped to the even factors / multiples of the target, offsets uniform and
floored to multiples of the chroma scale.  :meth:`RandomResizedCrop.draw`
draws them from an explicit ``torch.Generator``; the crop itself takes them
as an argument, so a test can hand over JAX's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rgbnomore_tpu_torch.ops.basis import resize_axis_operator

__all__ = [
    "RandomResizedCrop",
    "crop_size_candidates",
    "make_center_crop_resize",
    "make_full_resize",
    "make_random_resized_crop",
]


def crop_size_candidates(target: int, canvas: int) -> list[int]:
    """Even factors of ``target`` plus multiples of ``target`` up to
    ``canvas``: the only crop sizes the reference's ``choose_closest`` can
    emit (``custom_transforms.py:550-555``, ``:571-578``)."""
    evens = sorted({f for f in range(2, target + 1) if target % f == 0 and f % 2 == 0})
    return evens + [target * k for k in range(2, canvas // target + 1)]


class _OnDevice:
    """Constant tensors and one copy of them on each device asked for, made
    at the first request: the crop's operators are uploaded once, not on
    every batch."""

    def __init__(self, *tensors: torch.Tensor):
        self._host = tensors
        self._copies: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        device = torch.device(device)
        if device.type == "cpu":
            return self._host
        if device not in self._copies:
            self._copies[device] = tuple(t.to(device) for t in self._host)
        return self._copies[device]


@functools.lru_cache(maxsize=None)
def _stacked_resize_operators(target: int, canvas: int, chroma: bool) -> np.ndarray:
    """(K, target*8, smax*8) stack of zero-padded resize operators, one per
    candidate size; ``chroma`` halves the sizes and the target."""
    cands = crop_size_candidates(target, canvas)
    if chroma:
        cands = [max(1, s // 2) for s in cands]
        tgt = math.ceil(target / 2)
    else:
        tgt = target
    smax = max(cands)
    out = np.zeros((len(cands), tgt * 8, smax * 8), np.float32)
    for k, s in enumerate(cands):
        out[k, :, : s * 8] = resize_axis_operator(s, tgt)
    return out


def _build_matrices(r_stack: torch.Tensor, size_idx: torch.Tensor, offset: torch.Tensor,
                    canvas: int) -> torch.Tensor:
    """Per-sample (B, target*8, canvas*8) crop + resize matrices: the size's
    operator with its columns moved right by ``offset`` blocks."""
    r = r_stack[size_idx]  # (B, T8, smax8)
    smax8 = r.shape[-1]
    cols = torch.arange(canvas * 8, device=r.device)[None, :] - offset[:, None] * 8
    valid = (cols >= 0) & (cols < smax8)
    idx = cols.clamp(0, smax8 - 1)[:, None, :].expand(-1, r.shape[1], -1)
    return torch.where(valid[:, None, :], torch.gather(r, 2, idx), 0.0)


def _apply_separable(coeff: torch.Tensor, m_h: torch.Tensor, m_w: torch.Tensor) -> torch.Tensor:
    """``coeff`` (B, C, H, W, 8, 8) through ``m_h`` (B, T8, H8) on the rows
    and ``m_w`` (B, T8', W8) on the columns -> (B, C, T, T', 8, 8)."""
    b, c, h, w = coeff.shape[:4]
    flat = coeff.permute(0, 1, 2, 4, 3, 5).reshape(b, c, h * 8, w * 8)
    out = m_h[:, None] @ flat @ m_w.transpose(1, 2)[:, None]
    t, tw = out.shape[2] // 8, out.shape[3] // 8
    return out.reshape(b, c, t, 8, tw, 8).permute(0, 1, 2, 4, 3, 5)


class RandomResizedCrop:
    """The batched random-resized crop of ``canvas``-block canvases to
    ``target`` blocks (chroma: canvas/2 -> ceil(target/2)).

    ``draw(generator, batch)`` gives the boxes ``(size_idx, i, j)``: the
    index of the crop size in ``crop_size_candidates`` and the top-left
    block, each (batch,) int64 on the generator's device.  ``crop(y, cbcr,
    boxes)`` applies them: ``y`` (B, 1, canvas, canvas, 8, 8) float,
    ``cbcr`` (B, 2, canvas/2, canvas/2, 8, 8).
    """

    def __init__(self, target: int, canvas: int, scale: tuple[float, float] = (0.05, 1.0),
                 chroma_scale: int = 2):
        self.target, self.canvas = target, canvas
        self.scale, self.chroma_scale = scale, chroma_scale
        cands = crop_size_candidates(target, canvas)
        self.cands = torch.tensor(cands, dtype=torch.int64)
        self.evens = torch.tensor([s for s in cands if s <= target], dtype=torch.int64)
        self.maxfac = int(self.evens.max())
        self._sizes = _OnDevice(self.cands, self.evens)
        self._operators = _OnDevice(
            torch.from_numpy(_stacked_resize_operators(target, canvas, False)),
            torch.from_numpy(_stacked_resize_operators(target, canvas, True)))

    def _snap(self, side: torch.Tensor) -> torch.Tensor:
        """The reference's factor-or-multiple snap of each side."""
        evens = self._sizes.on(side.device)[1]
        fac = evens[torch.argmin((evens[None, :] - side[:, None]).abs(), dim=1)]
        mult = torch.round(side / self.maxfac) * self.maxfac
        mult = torch.where(mult > self.canvas, mult - self.maxfac, mult)
        return torch.where(side <= self.maxfac, fac.to(side.dtype), mult).to(torch.int64)

    def draw(self, generator: torch.Generator, batch: int):
        dev = generator.device
        lo, hi = self.scale
        u = torch.rand(batch, generator=generator, device=dev, dtype=torch.float32)
        area = self.canvas * self.canvas * (lo + (hi - lo) * u)
        size = self._snap(torch.round(torch.sqrt(area))).clamp(min=2)
        cs = self.chroma_scale
        # offsets U{0, ..., canvas - size}, floored to multiples of the chroma scale
        span = (self.canvas - size + 1).to(torch.float32)
        i = (torch.rand(batch, generator=generator, device=dev) * span).to(torch.int64)
        j = (torch.rand(batch, generator=generator, device=dev) * span).to(torch.int64)
        size_idx = torch.searchsorted(self._sizes.on(dev)[0], size)
        return size_idx, i // cs * cs, j // cs * cs

    def crop(self, y: torch.Tensor, cbcr: torch.Tensor, boxes):
        size_idx, i, j = (t.to(device=y.device, dtype=torch.int64) for t in boxes)
        r_y, r_c = self._operators.on(y.device)
        cs, c_canvas = self.chroma_scale, self.canvas // self.chroma_scale
        y_out = _apply_separable(y, _build_matrices(r_y, size_idx, i, self.canvas),
                                 _build_matrices(r_y, size_idx, j, self.canvas))
        c_out = _apply_separable(cbcr, _build_matrices(r_c, size_idx, i // cs, c_canvas),
                                 _build_matrices(r_c, size_idx, j // cs, c_canvas))
        return y_out, c_out


def make_random_resized_crop(target: int, canvas: int, scale: tuple[float, float] = (0.05, 1.0),
                             chroma_scale: int = 2) -> RandomResizedCrop:
    """The batched random-resized crop (``crops.py:110-170``)."""
    return RandomResizedCrop(target, canvas, scale, chroma_scale)


def _broadcast_crop(m_y: np.ndarray, m_c: np.ndarray):
    """``fn(y, cbcr)``: the same row and column matrices for every sample."""
    matrices = _OnDevice(torch.from_numpy(m_y), torch.from_numpy(m_c))

    def run(y: torch.Tensor, cbcr: torch.Tensor):
        b = y.shape[0]
        my, mc = (m.expand(b, -1, -1) for m in matrices.on(y.device))
        return _apply_separable(y, my, my), _apply_separable(cbcr, mc, mc)

    return run


def make_center_crop_resize(size_resize: int, size_crop: int, canvas: int,
                            chroma_scale: int = 2):
    """The batched ResizedCenterCrop of the ViT's eval (``crops.py:173-197``,
    the reference's ``custom_transforms.py:819-911``): a centered crop of
    ``round(size_crop / size_resize * canvas)`` blocks (snapped), resized to
    ``size_crop``; one static matrix pair.  ``fn(y, cbcr) -> (y, cbcr)``."""
    ratio = size_crop / size_resize
    cands = crop_size_candidates(size_crop, canvas)
    evens = np.asarray([c for c in cands if c <= size_crop], np.int32)
    maxfac = int(evens.max())

    def choose(val: int, maxval: int) -> int:
        if val <= maxfac:
            return int(evens[np.argmin(np.abs(evens - val))])
        m = round(val / maxfac) * maxfac
        return m - maxfac if m > maxval else m

    s = max(1, choose(round(ratio * canvas), canvas))
    i = (canvas - s) // 2 // chroma_scale * chroma_scale

    def static_matrix(src: int, tgt: int, cvs: int, off: int) -> np.ndarray:
        m = np.zeros((tgt * 8, cvs * 8), np.float32)
        m[:, off * 8: off * 8 + src * 8] = resize_axis_operator(src, tgt)
        return m

    m_y = static_matrix(s, size_crop, canvas, i)
    m_c = static_matrix(max(1, s // chroma_scale), math.ceil(size_crop / chroma_scale),
                        canvas // chroma_scale, i // chroma_scale)
    return _broadcast_crop(m_y, m_c)


def make_full_resize(target: int, canvas: int, chroma_scale: int = 2):
    """The batched Resize_DCT of the whole canvas (SwinV2's eval,
    ``crops.py:200-211``).  ``fn(y, cbcr) -> (y, cbcr)``."""
    m_y = resize_axis_operator(canvas, target).astype(np.float32)
    m_c = resize_axis_operator(canvas // chroma_scale,
                               math.ceil(target / chroma_scale)).astype(np.float32)
    return _broadcast_crop(m_y, m_c)
