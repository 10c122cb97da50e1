"""Fused softmax attention: the CUDA kernel's wrapper and its plain version.

Port of the forward half of ``rgbnomore_tpu/ops/pallas/attention.py``
(``fused_attention``, ``_fwd_kernel`` :39-48).  ``fused_attention(q, k, v,
scale)`` keeps the JAX call contract: q, k, v are (B, H, N, D) and the
result is ``softmax(scale * QKᵀ) V``.  On CUDA tensors it launches
``csrc/attention_fwd.cu`` or raises; on CPU tensors it runs
``attention_plain``, the einsum path of the JAX ViT (``models/vit.py:69-73``)
that the tests and ``chip_smoke.py`` hold the kernel against.

The backward kernel (``_bwd_kernel``) comes with the train slice, behind a
``torch.autograd.Function``; until then CUDA inputs that require grad are
refused rather than silently detached.
"""

from __future__ import annotations

import ctypes

import torch

from rgbnomore_tpu_torch.ops import cuda_build

__all__ = ["attention_plain", "fused_attention"]

_MAX_HEAD_DIM = 128  # the kernel keeps D/16 output columns per thread in registers


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(scale * QKᵀ) V`` as einsum -> float32 softmax -> einsum."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    att = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, N, D), got rank {q.dim()}")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"fused_attention takes float32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if q.numel() == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("attention_fwd")
    if lib.attention_fwd.argtypes is None:  # first use: declare the C signatures
        lib.attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.attention_fwd.restype = ctypes.c_int
        lib.attention_error_string.argtypes = [ctypes.c_int]
        lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention ``softmax(scale * QKᵀ) V`` over (B, H, N, D) float32.

    CPU tensors take :func:`attention_plain`.  CUDA tensors launch the
    hand-written kernel on the current stream (D <= 128, any N) and add one
    to ``fused_attention.launches``; a refused launch raises.
    """
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "fused_attention has no backward kernel yet (it comes with the "
            "train slice); call it under torch.no_grad() or inference_mode()")
    b, h, n, d = q.shape
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM} is not supported by the kernel")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b * h, n, d, float(scale), stream)
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"attention_fwd launch failed: {msg} (cudaError {err})")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches since the count was last reset
