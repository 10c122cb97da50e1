"""FFT-based fast DCT and DCT <-> DFT conversions (PyTorch).

Port of ``rgbnomore_tpu/ops/fastdct.py``, the Makhoul fast-DCT family the
reference keeps in ``utils/dct_torch_utils.py:8-230``.  Every function works
on the last one or two axes.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "fct_1d",
    "ifct_1d",
    "fct_2d",
    "ifct_2d",
    "dct2dft_fast_1d",
    "dct2dft_fast_2d",
    "dft2dct_1d",
    "dft2dct_2d",
    "dct2dft_2n_1d",
    "dft2dct_2n_1d",
    "dct2dft_2n_2d",
    "dft2dct_2n_2d",
    "phase_shift_dft_1d",
    "phase_shift_dft_2d",
]


def _ortho_scale(n: int, inverse: bool, device) -> torch.Tensor:
    """(n,) ``1 / (2 sqrt(n/2))`` with ``1 / (2 sqrt(n))`` first, or their
    reciprocals (``inverse``)."""
    scale = torch.full((n,), math.sqrt(n / 2.0) * 2.0, device=device)
    scale[0] = math.sqrt(1.0 * n) * 2.0
    return scale if inverse else 1.0 / scale


def _twiddle(n: int, sign: float, denom: float, device) -> torch.Tensor:
    """``exp(sign * 1j * pi * k / denom)`` for k < n, complex64."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return torch.polar(torch.ones_like(k), sign * k * math.pi / denom)


def _swap2d(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` along the last axis, then along the second-to-last."""
    x = fn(x, *args)
    return fn(x.transpose(-1, -2), *args).transpose(-1, -2)


def fct_1d(signal: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Fast DCT-II along the last axis (Makhoul; ``dct_torch_utils.py:8-36``)."""
    n = signal.shape[-1]
    rearranged = torch.cat([signal[..., ::2], torch.flip(signal[..., 1::2], dims=(-1,))], dim=-1)
    coeff = torch.fft.fft(rearranged, dim=-1) * _twiddle(n, -1.0, 2 * n, signal.device)
    if norm == "ortho":
        coeff = coeff * _ortho_scale(n, False, signal.device)
    return 2.0 * coeff.real


def _dct_to_half_dft(coeff: torch.Tensor, norm: str) -> torch.Tensor:
    """The same-length DFT of a DCT along the last axis
    (``dct_torch_utils.py:88-105``)."""
    n = coeff.shape[-1]
    c = coeff * _ortho_scale(n, True, coeff.device) if norm == "ortho" else coeff
    flipped = torch.cat([torch.zeros_like(c[..., :1]), torch.flip(c[..., 1:], dims=(-1,))],
                        dim=-1)
    return _twiddle(n, 1.0, 2 * n, coeff.device) * (c - 1j * flipped) / 2.0


def ifct_1d(coeff: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Inverse of :func:`fct_1d` (``dct_torch_utils.py:38-64``)."""
    n = coeff.shape[-1]
    sig = torch.fft.ifft(_dct_to_half_dft(coeff, norm), dim=-1).real
    half = n - n // 2
    out = torch.zeros_like(sig)
    out[..., ::2] = sig[..., :half]
    out[..., 1::2] = torch.flip(sig[..., half:], dims=(-1,))
    return out


def fct_2d(signal: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """2-D fast DCT on the last two axes."""
    return _swap2d(fct_1d, signal, norm)


def ifct_2d(coeff: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """2-D inverse fast DCT on the last two axes."""
    return _swap2d(ifct_1d, coeff, norm)


def dct2dft_fast_1d(dct: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Same-length DCT -> DFT conversion (``dct_torch_utils.py:88-105``)."""
    return _dct_to_half_dft(dct, norm)


def dct2dft_fast_2d(dct: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    return _swap2d(dct2dft_fast_1d, dct, norm)


def dft2dct_1d(dft: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Same-length DFT -> DCT conversion (``dct_torch_utils.py:115-133``)."""
    n = dft.shape[-1]
    dct = (2.0 * dft * _twiddle(n, -1.0, 2 * n, dft.device)).real
    return dct * _ortho_scale(n, False, dft.device) if norm == "ortho" else dct


def dft2dct_2d(dft: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    return _swap2d(dft2dct_1d, dft, norm)


def dct2dft_2n_1d(dct: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """The DFT of the length-2N mirrored sequence from a length-N DCT
    (``dct_torch_utils.py:143-163``)."""
    n = dct.shape[-1]
    c = dct * _ortho_scale(n, True, dct.device) if norm == "ortho" else dct
    back = -torch.flip(c, dims=(-1,))[..., :-1]
    recon = torch.cat([c, torch.zeros_like(c[..., :1]), back], dim=-1).to(torch.complex64)
    return recon * _twiddle(2 * n, 1.0, 2 * n, dct.device)


def dft2dct_2n_1d(dft: torch.Tensor, norm: str = "ortho",
                  takereal: bool = True) -> torch.Tensor:
    """A length-N DCT from the mirrored length-2N DFT
    (``dct_torch_utils.py:165-192``)."""
    n2 = dft.shape[-1]
    x = dft.to(torch.complex64) * _twiddle(n2, -1.0, n2, dft.device)
    if norm == "ortho":
        scale = torch.full((n2,), 1.0 / (math.sqrt(n2 / 4.0) * 2.0), device=dft.device)
        scale[0] = 1.0 / (math.sqrt(n2 / 2.0) * 2.0)
        x = x * scale
    x = x[..., : n2 // 2]
    return x.real if takereal else x


def dct2dft_2n_2d(dct: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    return _swap2d(dct2dft_2n_1d, dct, norm)


def dft2dct_2n_2d(dft: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    x = dft2dct_2n_1d(dft, norm, takereal=False)
    return dft2dct_2n_1d(x.transpose(-1, -2), norm, takereal=True).transpose(-1, -2)


def phase_shift_dft_1d(dft: torch.Tensor, degrees: float = 45.0) -> torch.Tensor:
    """Constant phase shift of the last axis (``dct_torch_utils.py:210-222``)."""
    rad = degrees / 180.0 * math.pi
    return dft * complex(math.cos(rad), math.sin(rad))


def phase_shift_dft_2d(dft: torch.Tensor, degrees: float = 45.0) -> torch.Tensor:
    return _swap2d(phase_shift_dft_1d, dft, degrees)
