"""Swin window attention: the CUDA kernels' wrappers and their plain versions.

Port of ``fused_window_attention`` from ``rgbnomore_tpu/ops/pallas/
attention.py`` (its forward ``_win_fwd_kernel`` :156-167 and its VJP
``_win_bwd_kernel`` :170-203).  ``window_attention(q, k, v, bias)`` takes
q, k, v (BW, H, N, D) float32 with the logit scale already folded into q,
and bias (P, H, N, N): window ``w`` uses pattern ``w % P`` (P = 1 for an
unshifted Swin block, P = nW for a shifted one, whose bias carries the shift
mask).  The result is ``softmax(QKᵀ + bias) V`` per window, differentiable
in q, k, v and bias; the bias gradient is the sum of dS over the windows
that share a pattern.  The TPU kernel's pair packing (two windows in one
128-row tile, -1e9 off the diagonal of a (NPAT, H, 2N, 2N) bias) exists for
the MXU and is not copied: a per-window kernel gives the same outputs and
the same diagonal-block bias gradient.

- On CUDA tensors, windows of N <= 64 tokens: the forward launches
  ``csrc/window_attention_fwd.cu`` (#3) and the backward
  ``csrc/window_attention_bwd.cu`` (#4; two kernels: the per-chunk pass and
  the fixed-order reduction of the bias gradient); both hold a whole window
  in one block and walk several windows a block.
- On CUDA tensors, windows of 64 < N <= 256 tokens (SwinV2 at window 16):
  the forward launches ``csrc/window_attention_tiled_fwd.cu`` (#3L: keys
  tiled, an online softmax, each row's log-sum-exp saved) and the backward
  ``csrc/window_attention_tiled_bwd.cu`` (#4L; four kernels: the rows'
  ``rowsum(dO * O)``, a key-major pass for dK, dV and the bias gradient's
  per-chunk sums, a query-major pass for dQ, the fixed-order reduction).
  All four compute their products in 3xTF32 on the tensor cores
  (``csrc/tf32_mma.cuh``; #4L's two passes as Hopper warpgroup products,
  ``csrc/wgmma.cuh``).  A refused launch raises; a CUDA tensor never
  takes the plain path.  The tiled pair takes any N <= 256, but at N = 64
  it needs 1.2x #3's and 3.1x #4's device time on an H100 (SwinV2-T's
  stages at batch 128, ``chip_smoke.py``'s kernel phase), so N <= 64 stays
  on #3 and #4.
- On CPU tensors the forward is :func:`window_attention_plain`, the einsum
  path of the JAX SwinV2 (``models/swinv2.py:207-215``), and the backward is
  autograd through it (:func:`window_attention_bwd_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from rgbnomore_tpu_torch.ops import cuda_build
from rgbnomore_tpu_torch.utils import profiling

__all__ = ["window_attention", "window_attention_bwd", "window_attention_bwd_plain",
           "window_attention_fwd", "window_attention_plain", "window_attention_tiled_bwd",
           "window_attention_tiled_fwd"]

MAX_TOKENS = 256  # N: #3L and #4L tile the keys
SMALL_TOKENS = 64  # N up to which a whole window stays in one block (#3, #4)
MAX_HEAD_DIM = 64
# windows of one pattern summed in registers by one backward block: enough
# to give each launch about 1,000 blocks or more, at most 32
_TARGET_BLOCKS = 1024
_MAX_CHUNK = 32
_TILED_KEYS = 64  # keys a block of #4L's key-major pass
# #4L's key-major pass runs one block an SM: about 512 blocks a launch or
# more, at most 64 windows a block (fewer, longer blocks ran 0.5-1.3% faster
# on the H100 at SwinV2-B/w16's stages than the #4 rule's)
_TILED_TARGET_BLOCKS = 512
_TILED_MAX_CHUNK = 64


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """``softmax(QKᵀ + bias[w % P]) V`` per window as einsum -> + bias ->
    float32 softmax -> einsum."""
    bw, h, n, _ = q.shape
    p = bias.shape[0]
    logits = torch.einsum("whqd,whkd->whqk", q, k)
    logits = (logits.reshape(bw // p, p, h, n, n) + bias).reshape(bw, h, n, n)
    att = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("whqk,whkd->whqd", att, v)


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, dout: torch.Tensor):
    """(dq, dk, dv, dbias) of :func:`window_attention_plain` for the output
    gradient ``dout``, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
        out = window_attention_plain(*leaves)
        return torch.autograd.grad(out, leaves, dout)


def _check_inputs(q, k, v, bias, *more) -> None:
    tensors = (q, k, v, *more)
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (BW, H, N, D), got rank {q.dim()}")
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"q, k, v shapes differ: {[tuple(t.shape) for t in tensors]}")
    bw, h, n, d = q.shape
    if bias.dim() != 4 or bias.shape[1:] != (h, n, n) or bias.shape[0] < 1:
        raise ValueError(f"bias must be (P, {h}, {n}, {n}), got {tuple(bias.shape)}")
    if bw % bias.shape[0]:
        raise ValueError(f"{bw} windows do not divide into {bias.shape[0]} bias patterns")
    if any(t.dtype != torch.float32 for t in (*tensors, bias)):
        raise TypeError(f"window_attention takes float32, got "
                        f"{[t.dtype for t in (*tensors, bias)]}")
    if any(t.device != q.device for t in (*tensors, bias)):
        raise ValueError("q, k, v and bias on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (*tensors, bias)):
        raise ValueError("q, k, v and bias must be contiguous")
    if q.numel() == 0:
        raise ValueError(f"empty window attention input {tuple(q.shape)}")
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"windows of {n} tokens with head dim {d}: the kernels take "
                         f"N <= {MAX_TOKENS} and D <= {MAX_HEAD_DIM}")


# kernel library -> (device pointers its C entry takes, int arguments after bw)
_ENTRIES = {"window_attention_fwd": (5, 4), "window_attention_bwd": (10, 5),
            "window_attention_tiled_fwd": (6, 4), "window_attention_tiled_bwd": (13, 5)}


def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: declare the C signatures
        n_ptrs, n_ints = _ENTRIES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong]
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, name + "_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def _require_cuda(q: torch.Tensor, tiled: bool) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the window attention kernels run on CUDA tensors, got {q.device}")
    n = q.shape[2]
    if not tiled and n > SMALL_TOKENS:
        raise ValueError(f"#3 and #4 take windows of N <= {SMALL_TOKENS} tokens, got {n}: "
                         "larger ones take the tiled kernels")


def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; adds one to the counter
    ``rgbnm.launch.window_attention_fwd``."""
    _check_inputs(q, k, v, bias)
    _require_cuda(q, tiled=False)
    bw, h, n, d = q.shape
    lib = _library("window_attention_fwd")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       bias.data_ptr(), out.data_ptr(), bw, h, n, d,
                                       bias.shape[0], stream)
    _raise_on(lib, "window_attention_fwd", err)
    profiling.count("rgbnm.launch.window_attention_fwd")
    return out


def _backward_chunk(bw: int, h: int, npat: int) -> int:
    """Windows of one pattern that one backward block sums in registers."""
    return max(1, min(_MAX_CHUNK, bw * h // _TARGET_BLOCKS, bw // npat))


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, dout: torch.Tensor, chunk: int | None = None):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv, dbias) from
    the forward's inputs and the output gradient ``dout``.  ``chunk``
    (default: enough for about 1,000 blocks, at most 32) is the number of
    windows of one pattern each block of the first pass sums.  Adds two to
    the counter ``rgbnm.launch.window_attention_bwd``: the per-chunk pass
    and the reduction of the bias gradient."""
    _check_inputs(q, k, v, bias, dout)
    _require_cuda(q, tiled=False)
    bw, h, n, d = q.shape
    npat = bias.shape[0]
    chunk = _backward_chunk(bw, h, npat) if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    chunks = -(-(bw // npat) // chunk)
    lib = _library("window_attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty_like(bias)
    partial = torch.empty((npat, chunks, h, n, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       bias.data_ptr(), dout.data_ptr(), partial.data_ptr(),
                                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                       db.data_ptr(), bw, h, n, d, npat, chunk, stream)
    _raise_on(lib, "window_attention_bwd", err)
    profiling.count("rgbnm.launch.window_attention_bwd", 2)
    return dq, dk, dv, db


def window_attention_tiled_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, lse: bool = False):
    """Launch #3L on CUDA tensors (any N <= 256): ``(out, lse)``, ``lse``
    each query row's log-sum-exp of its logits (BW, H, N) where asked for,
    else None.  Adds one to the counter
    ``rgbnm.launch.window_attention_tiled_fwd``."""
    _check_inputs(q, k, v, bias)
    _require_cuda(q, tiled=True)
    bw, h, n, d = q.shape
    lib = _library("window_attention_tiled_fwd")
    out = torch.empty_like(q)
    rows = torch.empty((bw, h, n), dtype=torch.float32, device=q.device) if lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_tiled_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             bias.data_ptr(), out.data_ptr(),
                                             None if rows is None else rows.data_ptr(),
                                             bw, h, n, d, bias.shape[0], stream)
    _raise_on(lib, "window_attention_tiled_fwd", err)
    profiling.count("rgbnm.launch.window_attention_tiled_fwd")
    return out, rows


def _tiled_chunk(bw: int, h: int, n: int, npat: int) -> int:
    """Windows of one pattern that one block of #4L's key-major pass walks."""
    tiles = -(-n // _TILED_KEYS)
    return max(1, min(_TILED_MAX_CHUNK, bw * h * tiles // _TILED_TARGET_BLOCKS, bw // npat))


def window_attention_tiled_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, chunk: int | None = None):
    """Launch #4L on CUDA tensors: (dq, dk, dv, dbias) from the forward's
    inputs, its output ``out`` and row log-sum-exp ``lse``
    (:func:`window_attention_tiled_fwd`), and the output gradient ``dout``.
    ``chunk`` (default: enough for about 512 blocks, at most 64) is the
    number of windows of one pattern whose bias gradient one block sums.
    Adds four to the counter ``rgbnm.launch.window_attention_tiled_bwd``:
    the rows' ``rowsum(dO * O)``, the key-major pass, the query-major pass
    and the reduction of the bias gradient."""
    _check_inputs(q, k, v, bias, out, dout)
    _require_cuda(q, tiled=True)
    bw, h, n, d = q.shape
    if lse.shape != (bw, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(bw, h, n)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    npat = bias.shape[0]
    chunk = _tiled_chunk(bw, h, n, npat) if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    chunks = -(-(bw // npat) // chunk)
    lib = _library("window_attention_tiled_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty_like(bias)
    delta = torch.empty_like(lse)
    partial = torch.empty((npat, chunks, h, n, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_tiled_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), partial.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), db.data_ptr(), bw, h, n, d, npat,
            chunk, stream)
    _raise_on(lib, "window_attention_tiled_bwd", err)
    profiling.count("rgbnm.launch.window_attention_tiled_bwd", 4)
    return dq, dk, dv, db


def _forward(q, k, v, bias, save: bool):
    """The forward of CPU or CUDA tensors, the kernels chosen by N:
    ``(out, saved, backward)``, where ``backward(*saved, dout)`` gives the
    four gradients (autograd through the plain version, #4 or #4L).  Without
    ``save`` (no gradient wanted) #3L keeps no log-sum-exp."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias), (q, k, v, bias), window_attention_bwd_plain
    if q.shape[2] <= SMALL_TOKENS:
        return window_attention_fwd(q, k, v, bias), (q, k, v, bias), window_attention_bwd
    # #4L takes the output (rowsum(dO * O)) and the rows' log-sum-exp
    out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=save)
    return out, (q, k, v, bias, out, lse), window_attention_tiled_bwd


class _WindowAttention(torch.autograd.Function):
    """The kernels on CUDA tensors (#3 and #4 up to 64 tokens, #3L and #4L
    past them); the plain version and autograd through it on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, saved, ctx.backward_of = _forward(q, k, v, bias, save=True)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        with profiling.span("rgbnm.winattn.bwd"):
            return ctx.backward_of(*ctx.saved_tensors, dout.contiguous())


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Window attention ``softmax(QKᵀ + bias[w % P]) V`` over (BW, H, N, D)
    float32 (N <= 256, D <= 64) with bias (P, H, N, N), differentiable in all
    four inputs.

    CPU tensors take :func:`window_attention_plain`.  CUDA tensors launch the
    hand-written kernels on the current stream, chosen by N: up to 64 tokens
    #3 (one to the counter ``rgbnm.launch.window_attention_fwd``) and #4 (two
    to ``rgbnm.launch.window_attention_bwd`` a backward), past 64 #3L (one to
    ``rgbnm.launch.window_attention_tiled_fwd``) and #4L (four to
    ``rgbnm.launch.window_attention_tiled_bwd``).  The call is the span
    ``rgbnm.winattn.fwd`` with N as its index, its backward
    ``rgbnm.winattn.bwd``.
    """
    _check_inputs(q, k, v, bias)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias))
    with profiling.span("rgbnm.winattn.fwd", q.shape[2]):
        if not grad:  # eval: nothing saved
            return _forward(q, k, v, bias, save=False)[0]
        return _WindowAttention.apply(q, k, v, bias)
