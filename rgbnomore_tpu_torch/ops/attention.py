"""Fused softmax attention: the CUDA kernels' wrappers and their plain versions.

Port of ``rgbnomore_tpu/ops/pallas/attention.py`` (``fused_attention``, its
forward ``_fwd_kernel`` :39-48 and its VJP ``_bwd_kernel`` :51-69).
``fused_attention(q, k, v, scale)`` keeps the JAX call contract: q, k, v are
(B, H, N, D) and the result is ``softmax(scale * QKᵀ) V``.  It is a
``torch.autograd.Function``:

- On CUDA tensors the forward launches ``csrc/attention_fwd.cu`` (with the
  per-row log-sum-exp when a gradient will be needed) and the backward
  launches ``csrc/attention_bwd.cu``; a refused launch raises.  Both compute
  their products in 3xTF32 on the tensor cores (``csrc/tf32_mma.cuh``),
  which keeps float32's precision: the card holds them to the Pallas
  tests' tolerances.
- On CPU tensors the forward is :func:`attention_plain`, the einsum path of
  the JAX ViT (``models/vit.py:69-73``), and the backward is autograd
  through it (:func:`attention_bwd_plain`).  The tests and ``chip_smoke.py``
  hold the kernels against these.
"""

from __future__ import annotations

import ctypes

import torch

from rgbnomore_tpu_torch.ops import cuda_build

__all__ = ["attention_bwd_plain", "attention_plain", "fused_attention",
           "fused_attention_bwd", "fused_attention_fwd"]

_MAX_HEAD_DIM = 128  # the kernels keep a warp's 16 x D output tile in registers


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(scale * QKᵀ) V`` as einsum -> float32 softmax -> einsum."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    att = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, scale: float):
    """(dq, dk, dv) of :func:`attention_plain` for the output gradient
    ``dout``, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*leaves, scale)
        return torch.autograd.grad(out, leaves, dout)


def _check_inputs(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, N, D), got rank {q.dim()}")
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"q, k, v shapes differ: {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"fused_attention takes float32, got {[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"q, k, v on different devices: {[t.device for t in tensors]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v must be contiguous")
    if q.numel() == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if q.device.type == "cuda" and q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {_MAX_HEAD_DIM} is not supported by "
                         "the kernel")


# kernel library -> (device pointers its C entry takes, its error-string function)
_ENTRIES = {"attention_fwd": (5, "attention_error_string"),
            "attention_bwd": (11, "attention_bwd_error_string")}


def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: declare the C signatures
        n_ptrs, err_name = _ENTRIES[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        getattr(lib, err_name).argtypes = [ctypes.c_int]
        getattr(lib, err_name).restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, _ENTRIES[name][1])(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        with_lse: bool = False):
    """Launch the forward kernel on CUDA tensors (B, H, N, D) float32:
    returns ``out``, or ``(out, lse)`` with each row's log-sum-exp (B, H, N)
    when ``with_lse``.  Adds one to ``fused_attention.launches``."""
    _check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    b, h, n, d = q.shape
    lib = _library("attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                None if lse is None else lse.data_ptr(), b * h, n, d,
                                float(scale), stream)
    _raise_on(lib, "attention_fwd", err)
    fused_attention.launches += 1
    return (out, lse) if with_lse else out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        scale: float):
    """Launch the backward kernel on CUDA tensors: (dq, dk, dv) from the
    forward's inputs, its output ``out``, its log-sum-exp ``lse`` (B, H, N)
    and the output gradient ``dout``.  Adds one to
    ``fused_attention_bwd.launches``."""
    _check_inputs(q, k, v, out, dout)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    b, h, n, d = q.shape
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 ({b}, {h}, {n}) on {q.device}")
    lib = _library("attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the kernel's scratch: rowsum(dout * out), and dS from its dK/dV pass
    # to its dQ pass
    delta = torch.empty_like(lse)
    ds = torch.empty((b, h, n, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                ds.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                b * h, n, d, float(scale), stream)
    _raise_on(lib, "attention_bwd", err)
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0  # kernel launches since the count was last reset


class _FusedAttention(torch.autograd.Function):
    """The kernels on CUDA tensors; the plain version and autograd through it
    on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_plain(q, k, v, scale)
        out, lse = fused_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if dout.device.type == "cpu":
            q, k, v = ctx.saved_tensors
            dq, dk, dv = attention_bwd_plain(q, k, v, dout, ctx.scale)
        else:
            dq, dk, dv = fused_attention_bwd(*ctx.saved_tensors, dout, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention ``softmax(scale * QKᵀ) V`` over (B, H, N, D) float32,
    differentiable in q, k and v.

    CPU tensors take :func:`attention_plain`.  CUDA tensors launch the
    hand-written kernels on the current stream (D <= 128, any N): the
    forward adds one to ``fused_attention.launches``, each backward one to
    ``fused_attention_bwd.launches``.
    """
    _check_inputs(q, k, v)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cuda" and not grad:  # eval: no log-sum-exp, nothing saved
        return fused_attention_fwd(q, k, v, scale)
    return _FusedAttention.apply(q, k, v, scale)


fused_attention.launches = 0  # forward kernel launches since the count was last reset
