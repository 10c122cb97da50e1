"""Fused softmax attention: the CUDA kernels' wrappers and their plain versions.

Port of ``rgbnomore_tpu/ops/pallas/attention.py`` (``fused_attention``, its
forward ``_fwd_kernel`` :39-48 and its VJP ``_bwd_kernel`` :51-69).
``fused_attention(q, k, v, scale)`` keeps the JAX call contract: q, k, v are
(B, H, N, D) float32, bf16 or fp16, all of one dtype, and the result is
``softmax(scale * QKᵀ) V`` in that dtype.  It is a
``torch.autograd.Function`` that dispatches on the dtype:

- On float32 CUDA tensors the forward launches ``csrc/attention_fwd.cu``
  (with the per-row log-sum-exp when a gradient will be needed) and the
  backward launches ``csrc/attention_bwd.cu``; a refused launch raises.
  Both compute their products in 3xTF32 on the tensor cores
  (``csrc/tf32_mma.cuh``), which keeps float32's precision: the card holds
  them to the Pallas tests' tolerances.
- On bf16 and fp16 CUDA tensors (mixed precision) they launch
  ``csrc/attention_h16_fwd.cu`` and ``csrc/attention_h16_bwd.cu`` instead,
  as the Pallas kernels compute on such inputs (``attention.py:39-69``):
  products of the half-precision operands accumulated in float32 on the
  tensor cores, the logits, softmax, log-sum-exp
  and dS in float32, P rounded to the input dtype only as an operand of
  PV, outputs in the input dtype.  Both issue their products as Hopper
  warpgroup products (``wgmma``, ``csrc/wgmma.cuh``) and keep a whole head
  in shared memory; the backward's dS never leaves it.  Nothing is upcast
  to float32 on the way in; their launches are counted apart
  (the counters ``rgbnm.launch.fused_attention_h16_fwd`` and ``_bwd``).
- On CPU tensors the forward is :func:`attention_plain`, the einsum path of
  the JAX ViT (``models/vit.py:69-73``), and the backward is autograd
  through it (:func:`attention_bwd_plain`).  The tests and ``chip_smoke.py``
  hold the kernels against these.
"""

from __future__ import annotations

import ctypes

import torch

from rgbnomore_tpu_torch.ops import cuda_build
from rgbnomore_tpu_torch.utils import profiling

__all__ = ["attention_bwd_plain", "attention_plain", "fused_attention",
           "fused_attention_bwd", "fused_attention_fwd", "fused_attention_h16_bwd",
           "fused_attention_h16_fwd"]

_MAX_HEAD_DIM = 128  # the kernels keep a query tile's outputs in registers
HALF_DTYPES = (torch.bfloat16, torch.float16)
_DTYPES = (torch.float32, *HALF_DTYPES)


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
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("fused_attention takes float32, bf16 or fp16, all of one dtype; "
                        f"got {[t.dtype for t in tensors]}")
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


# kernel library -> (device pointers its C entry takes, whether it takes the
# element type, its error-string function)
_ENTRIES = {"attention_fwd": (5, False, "attention_error_string"),
            "attention_bwd": (11, False, "attention_bwd_error_string"),
            "attention_h16_fwd": (5, True, "attention_h16_fwd_error_string"),
            "attention_h16_bwd": (10, True, "attention_h16_bwd_error_string")}
# the half-precision entries' element type argument
_ELEMENT = {torch.float16: 0, torch.bfloat16: 1}


def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: declare the C signatures
        n_ptrs, typed, err_name = _ENTRIES[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            *([ctypes.c_int] if typed else []), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        getattr(lib, err_name).argtypes = [ctypes.c_int]
        getattr(lib, err_name).restype = ctypes.c_char_p
        if name == "attention_h16_bwd":
            lib.attention_h16_bwd_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int]
            lib.attention_h16_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, _ENTRIES[name][2])(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def _launch_fwd(name: str, q, k, v, scale, with_lse):
    _check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    b, h, n, d = q.shape
    lib = _library(name)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    typed = (_ELEMENT[q.dtype],) if _ENTRIES[name][1] else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 None if lse is None else lse.data_ptr(), b * h, n, d,
                                 float(scale), *typed, stream)
    _raise_on(lib, name, err)
    return (out, lse) if with_lse else out


def _launch_bwd(name: str, q, k, v, out, lse, dout, scale):
    _check_inputs(q, k, v, out, dout)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    b, h, n, d = q.shape
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 ({b}, {h}, {n}) on {q.device}")
    lib = _library(name)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if name == "attention_h16_bwd":
        # scratch: dQ's float32 sums over key groups where one block cannot
        # hold a head's keys (N > 256; N > 128 at D > 64); the kernel keeps
        # dS on chip
        elems = lib.attention_h16_bwd_scratch(b * h, n, d)
        buf = torch.empty(elems, dtype=torch.float32, device=q.device) if elems else None
        scratch = (None if buf is None else buf.data_ptr(),)
    else:
        # the float32 kernel's scratch: rowsum(dout * out), and dS from its
        # dK/dV pass to its dQ pass
        delta = torch.empty_like(lse)
        ds = torch.empty((b, h, n, n), dtype=torch.float32, device=q.device)
        scratch = (delta.data_ptr(), ds.data_ptr())
    typed = (_ELEMENT[q.dtype],) if _ENTRIES[name][1] else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 dout.data_ptr(), lse.data_ptr(), *scratch, dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), b * h, n, d, float(scale),
                                 *typed, stream)
    _raise_on(lib, name, err)
    return dq, dk, dv


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        with_lse: bool = False):
    """Launch the float32 forward kernel on CUDA tensors (B, H, N, D)
    float32: returns ``out``, or ``(out, lse)`` with each row's log-sum-exp
    (B, H, N) when ``with_lse``.  Adds one to the counter
    ``rgbnm.launch.fused_attention_fwd``."""
    if q.dtype != torch.float32:
        raise TypeError(f"the float32 attention kernel takes float32, got {q.dtype}")
    res = _launch_fwd("attention_fwd", q, k, v, scale, with_lse)
    profiling.count("rgbnm.launch.fused_attention_fwd")
    return res


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        scale: float):
    """Launch the float32 backward kernel on CUDA tensors: (dq, dk, dv) from
    the forward's inputs, its output ``out``, its log-sum-exp ``lse`` (B, H,
    N) and the output gradient ``dout``.  Adds one to the counter
    ``rgbnm.launch.fused_attention_bwd``."""
    if q.dtype != torch.float32:
        raise TypeError(f"the float32 attention kernel takes float32, got {q.dtype}")
    res = _launch_bwd("attention_bwd", q, k, v, out, lse, dout, scale)
    profiling.count("rgbnm.launch.fused_attention_bwd")
    return res


def fused_attention_h16_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            with_lse: bool = False):
    """Launch the half-precision forward kernel on CUDA tensors (B, H, N, D)
    bf16 or fp16: returns ``out`` in that dtype, or ``(out, lse)`` with
    each row's float32 log-sum-exp (B, H, N) when ``with_lse``.  Adds one to
    the counter ``rgbnm.launch.fused_attention_h16_fwd``."""
    if q.dtype not in HALF_DTYPES:
        raise TypeError(f"the half-precision attention kernel takes bf16 or fp16, got {q.dtype}")
    res = _launch_fwd("attention_h16_fwd", q, k, v, scale, with_lse)
    profiling.count("rgbnm.launch.fused_attention_h16_fwd")
    return res


def fused_attention_h16_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            scale: float):
    """Launch the half-precision backward kernel on CUDA tensors of one
    dtype, bf16 or fp16: (dq, dk, dv) in it, as ``fused_attention_bwd``.
    Adds one to the counter ``rgbnm.launch.fused_attention_h16_bwd``."""
    if q.dtype not in HALF_DTYPES:
        raise TypeError(f"the half-precision attention kernel takes bf16 or fp16, got {q.dtype}")
    res = _launch_bwd("attention_h16_bwd", q, k, v, out, lse, dout, scale)
    profiling.count("rgbnm.launch.fused_attention_h16_bwd")
    return res


class _FusedAttention(torch.autograd.Function):
    """The kernels on CUDA tensors; the plain version and autograd through it
    on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_plain(q, k, v, scale)
        fwd = fused_attention_fwd if q.dtype == torch.float32 else fused_attention_h16_fwd
        out, lse = fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        with profiling.span("rgbnm.attn.bwd"):
            dout = dout.contiguous()
            if dout.device.type == "cpu":
                q, k, v = ctx.saved_tensors
                dq, dk, dv = attention_bwd_plain(q, k, v, dout, ctx.scale)
            else:
                bwd = fused_attention_bwd if dout.dtype == torch.float32 \
                    else fused_attention_h16_bwd
                dq, dk, dv = bwd(*ctx.saved_tensors, dout, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention ``softmax(scale * QKᵀ) V`` over (B, H, N, D) float32,
    bf16 or fp16, differentiable in q, k and v.

    CPU tensors take :func:`attention_plain`.  CUDA tensors launch the
    hand-written kernels on the current stream (D <= 128, any N): float32
    the 3xTF32 ones, whose forward adds one to the counter
    ``rgbnm.launch.fused_attention_fwd`` and backward one to
    ``rgbnm.launch.fused_attention_bwd``; bf16 and fp16 the half-precision
    ones, counted in ``rgbnm.launch.fused_attention_h16_fwd`` and ``_bwd``.
    The call is the span ``rgbnm.attn.fwd``, its backward ``rgbnm.attn.bwd``.
    """
    _check_inputs(q, k, v)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    with profiling.span("rgbnm.attn.fwd"):
        if q.device.type == "cuda" and not grad:  # eval: no log-sum-exp, nothing saved
            if q.dtype == torch.float32:
                return fused_attention_fwd(q, k, v, scale)
            return fused_attention_h16_fwd(q, k, v, scale)
        return _FusedAttention.apply(q, k, v, scale)
