"""DCT / DFT basis and conversion matrices.

Matrices are computed once on the host in float64 for accuracy, cached, and
returned as float32 numpy arrays; callers move them to their device.  This
module is a numpy-only copy of ``rgbnomore_tpu/ops/basis.py``.

Math background (mirrors the algebra described in the RGB-no-more paper and
exercised by the reference implementation at ``utils/dct_ops.py:150-235``):

- ``dct_basis_matrix(n)`` returns the orthonormal DCT-II analysis matrix
  ``B`` with ``B[k, i] = s_k * sqrt(2/n) * cos(pi/n * k * (i + 1/2))`` so that
  for a signal ``x``, ``X = B @ x`` are its DCT coefficients and
  ``B @ B.T = I``.
- ``conversion_matrix(ls, mult)`` maps the concatenated coefficients of
  ``mult`` adjacent small DCT blocks (size ``ls``) onto the coefficients of
  one large DCT block of size ``ls * mult``:  ``C = B_large @ blockdiag(B_small)^T``.
  It is orthonormal, so the inverse map is ``C.T``.
- ``resize_axis_operator(src, dst)`` composes zero-pad spectral upsampling and
  spectral truncation downsampling (the gcd trick of
  ``utils/dct_ops.py:529-580``) into ONE dense matrix per axis, so a full 2-D
  crop+resize becomes two batched matmuls instead of a chain of small
  einsums.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "dct_basis_matrix",
    "fourier_basis_matrix",
    "conversion_matrix",
    "conversion_matrix_dft",
    "expand_basis_blockwise",
    "resize_axis_operator",
    "KSIZE",
]

KSIZE = 8  # JPEG DCT block size


@functools.lru_cache(maxsize=None)
def dct_basis_matrix(length: int = KSIZE, scale: bool = True) -> np.ndarray:
    """Orthonormal (if ``scale``) DCT-II basis matrix of shape (length, length)."""
    k = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(length, dtype=np.float64)[None, :] + 0.5
    basis = np.cos(k * i * np.pi / length)
    if scale:
        basis[0] *= 1.0 / math.sqrt(2.0)
        basis *= math.sqrt(2.0 / length)
    out = basis.astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def fourier_basis_matrix(length: int = KSIZE, scale: bool = True) -> np.ndarray:
    """Unitary (if ``scale``) DFT matrix of shape (length, length), complex64."""
    t = np.arange(length, dtype=np.float64)[:, None]
    k = np.arange(length, dtype=np.float64)[None, :]
    basis = np.exp(-2j * np.pi * t * k / length)
    if scale:
        basis /= math.sqrt(length)
    out = basis.astype(np.complex64)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def expand_basis_blockwise(length: int, mult: int) -> np.ndarray:
    """Block-diagonal matrix with ``mult`` copies of the DCT basis on the diagonal."""
    small = dct_basis_matrix(length).astype(np.float64)
    n = length * mult
    out = np.zeros((n, n), dtype=np.float64)
    for m in range(mult):
        out[m * length : (m + 1) * length, m * length : (m + 1) * length] = small
    out32 = out.astype(np.float32)
    out32.setflags(write=False)
    return out32


@functools.lru_cache(maxsize=None)
def conversion_matrix(length_small: int, mult: int) -> np.ndarray:
    """Projection of ``mult`` stacked small DCT blocks onto one large DCT basis.

    Shape ``(length_small*mult, length_small*mult)``; orthonormal, so the
    decompose direction is its transpose.  ``mult == 1`` returns identity.
    """
    if mult == 1:
        out = np.eye(length_small, dtype=np.float32)
        out.setflags(write=False)
        return out
    large = dct_basis_matrix(length_small * mult).astype(np.float64)
    small_blocks = expand_basis_blockwise(length_small, mult).astype(np.float64)
    out = (large @ small_blocks.T).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def conversion_matrix_dft(length_small: int, mult: int) -> np.ndarray:
    """Like :func:`conversion_matrix` but the large basis is a unitary DFT.

    Maps stacked small-DCT-block coefficients to the coefficients of one large
    DFT block (used by the exact rotate/shear path).  complex64.
    """
    large = fourier_basis_matrix(length_small * mult).astype(np.complex128)
    small_blocks = expand_basis_blockwise(length_small, mult).astype(np.complex128)
    out = (large @ small_blocks.conj().T).astype(np.complex64)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _upsample_block_operator(us: int, ksize: int = KSIZE) -> np.ndarray:
    """Per-block 1-D upsample: 8 coeffs -> us blocks x 8 coeffs.

    Zero-pad the spectrum to ``us*ksize`` scaled by ``sqrt(us)`` then decompose
    with the conversion matrix: ``T_up = C.T[:, :ksize] * sqrt(us)``.
    Shape ``(us*ksize, ksize)``.
    """
    conv = conversion_matrix(ksize, us).astype(np.float64)
    out = (conv.T[:, :ksize] * math.sqrt(us)).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _downsample_block_operator(ds: int, ksize: int = KSIZE) -> np.ndarray:
    """Per-group 1-D downsample: ds blocks x 8 coeffs -> 8 coeffs.

    Combine ``ds`` blocks into one large spectrum, truncate to the first
    ``ksize`` coefficients, scale by ``1/sqrt(ds)``:
    ``T_dn = C[:ksize, :] / sqrt(ds)``.  Shape ``(ksize, ds*ksize)``.
    """
    conv = conversion_matrix(ksize, ds).astype(np.float64)
    out = (conv[:ksize, :] / math.sqrt(ds)).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def resize_axis_operator(src: int, dst: int, ksize: int = KSIZE) -> np.ndarray:
    """Dense 1-D resize operator on the flattened ``(block, freq)`` axis.

    Returns ``R`` of shape ``(dst*ksize, src*ksize)`` such that applying ``R``
    along an axis of a coefficient array laid out as ``(blocks, ksize)``
    (flattened) performs the reference's gcd-based upsample-then-downsample
    resize (``utils/dct_ops.py:529-580``) in one matmul.
    """
    if src == dst:
        out = np.eye(src * ksize, dtype=np.float32)
        out.setflags(write=False)
        return out
    g = math.gcd(src, dst)
    us = dst // g
    ds = src // g
    t_up = _upsample_block_operator(us, ksize).astype(np.float64)
    t_dn = _downsample_block_operator(ds, ksize).astype(np.float64)
    # U: (src*us*ksize, src*ksize) = I_src (x) T_up
    u = np.kron(np.eye(src), t_up)
    # D: (dst*ksize, src*us*ksize) = I_dst (x) T_dn   (src*us == dst*ds)
    d = np.kron(np.eye(dst), t_dn)
    out = (d @ u).astype(np.float32)
    out.setflags(write=False)
    return out
