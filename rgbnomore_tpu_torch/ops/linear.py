"""Float32 Linear layers in 3xTF32: the CUDA kernel's wrappers and their plain version.

``linear_tf32x3(x, weight, bias)`` is ``F.linear`` at float32 for
``models/layers.py:Linear``: ``x @ weight.T + bias`` over x's last dim, a
``torch.autograd.Function`` differentiable in all three.  It replaces no
Pallas kernel (the JAX package leaves these products to XLA); it exists
because cuBLAS runs float32 products with TF32 off on the CUDA cores, where
ViT-S's GEMMs reach about 49 TFLOP/s, while 3xTF32 on the tensor cores
keeps float32's accuracy at up to 165 (``csrc/linear_tf32x3.cu``).

- On CUDA tensors the forward launches ``linear_tf32x3_mm`` with the
  weight's hi and lo halves (``linear_tf32x3_split``) and the bias in its
  epilogue; the backward launches it again for dX = dY W (the weight's
  halves transposed) and ``linear_tf32x3_wgrad`` for dW = dYᵀ X and db,
  which repeat bit for bit.  A launch the kernel refuses raises; nothing
  falls back to another route.  A bf16 or fp16 weight (SwinV2's qkv,
  rounded to the compute dtype before the product promotes) is promoted
  here; it is exact in TF32, so its lo half is zero and the forward and
  input gradient leave the products with that half out (they add only
  zeros: the same result bit for bit, a third fewer products).  Launches
  count in ``rgbnm.launch.linear_tf32x3_fwd``, ``_dgrad`` and ``_wgrad``.
- On CPU tensors every product is :func:`mm_tf32x3`, the kernel's arithmetic
  in plain PyTorch: each operand split as x = hi + lo (hi = x rounded to
  TF32, ties away from zero; lo read as TF32 by truncation), the cross terms
  first, then hi·hi.  It is one operator, ``rgbnm::mm_tf32x3``, whose FLOP
  count is its 2·M·N·K, so ``utils/profiling.model_flops`` counts a Linear
  as before.

Autograd saves x and the weight, as ``F.linear`` does; a half weight's
gradient is rounded to its dtype, as its promotion's backward rounds it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from rgbnomore_tpu_torch.ops import cuda_build
from rgbnomore_tpu_torch.utils import profiling

__all__ = ["check_shape", "linear_dgrad", "linear_fwd", "linear_plain", "linear_tf32x3",
           "linear_wgrad", "mm_tf32x3", "tf32_split"]

# the kernel's TMA coordinates are 32-bit: rows of A below 2^31 less a tile
_MAX_ROWS = (1 << 31) - 128


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of a float32 tensor as ``csrc/tf32_mma.cuh``'s ``split``
    makes them and the tensor cores read them: hi = x rounded to TF32 (ten
    mantissa bits, to nearest with ties away from zero, by adding half the
    unit of the 13 dropped bits to the bit pattern), lo = x - hi with its low
    13 bits dropped."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_hi @ b_lo.T + a_lo @ b_hi.T) + a_hi @ b_hi.T


# one operator, so that a FLOP counter sees one product (``torch.library``'s
# low-level registration: ``custom_op`` reads its caller's source, and so
# walks ``sys.modules`` as the port's tests must not let it)
_LIB = torch.library.Library("rgbnm", "FRAGMENT")
_LIB.define("mm_tf32x3(Tensor a, Tensor b) -> Tensor")
_LIB.impl("mm_tf32x3", _mm_tf32x3, "CompositeExplicitAutograd")


@register_flop_formula(torch.ops.rgbnm.mm_tf32x3)
def _mm_tf32x3_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[0]


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for a (M, K) and b (N, K) float32 in 3xTF32:
    ``(a_hi b_loᵀ + a_lo b_hiᵀ) + a_hi b_hiᵀ``, each product summed in
    float32 (:func:`tf32_split`); the operator ``rgbnm::mm_tf32x3``."""
    return torch.ops.rgbnm.mm_tf32x3(a, b)


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T + bias`` over x's last dim, the product in 3xTF32
    (:func:`mm_tf32x3`; a half weight promoted), the bias added after it as
    the kernel's epilogue adds it."""
    out = mm_tf32x3(x.reshape(-1, x.shape[-1]), weight.float())
    if bias is not None:
        out = out + bias
    return out.reshape(*x.shape[:-1], weight.shape[0])


def check_shape(m: int, n: int, k: int) -> None:
    """Raise ``ValueError`` unless the kernel takes a Linear of ``k`` input
    and ``n`` output features over ``m`` rows: any positive sizes, ragged
    against every tile, with fewer than 2^31 - 128 rows."""
    if m <= 0 or n <= 0 or k <= 0:
        raise ValueError(f"empty Linear: {m} rows, {k} -> {n} features")
    if m > _MAX_ROWS:
        raise ValueError(f"a Linear over {m} rows: the kernel takes at most {_MAX_ROWS}")


# the weight's dtypes: float32, or a half dtype, exact in TF32
_WEIGHT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> None:
    tensors = [x, weight] + ([] if bias is None else [bias])
    if any(t.dtype != torch.float32 for t in tensors if t is not weight) or (
            weight.dtype not in _WEIGHT_DTYPES):
        raise TypeError("linear_tf32x3 takes float32 (the weight float32, bf16 or fp16), "
                        f"got {[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"x, weight, bias on different devices: {[t.device for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and weight {tuple(weight.shape)} do not match")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} for weight {tuple(weight.shape)}")


# ----------------------------------------------------------------- kernels
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("linear_tf32x3")
    if lib.linear_tf32x3_mm.argtypes is None:  # first use: declare the C signatures
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.linear_tf32x3_split.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr]
        lib.linear_tf32x3_mm.argtypes = [ptr, i64, i32, i64, ptr, i32, i32, ptr, ptr, i32, ptr]
        lib.linear_tf32x3_wgrad_scratch.argtypes = [i64, i32, i32, i32]
        lib.linear_tf32x3_wgrad_scratch.restype = i64
        lib.linear_tf32x3_wgrad.argtypes = [ptr, i64, ptr, i64, i64, i32, i32, ptr, ptr, ptr,
                                            ptr]
        lib.linear_tf32x3_error_string.argtypes = [i32]
        lib.linear_tf32x3_error_string.restype = ctypes.c_char_p
        for fn in (lib.linear_tf32x3_split, lib.linear_tf32x3_mm, lib.linear_tf32x3_wgrad):
            fn.restype = i32
    return lib


def _raise_on(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err != 0:
        msg = lib.linear_tf32x3_error_string(err).decode()
        raise RuntimeError(f"linear_tf32x3 {what} launch failed: {msg} (error {err})")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous (rows, last dim) matrix."""
    return t.reshape(-1, t.shape[-1]).contiguous()


def _on_cuda(*tensors: torch.Tensor) -> None:
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("the linear_tf32x3 kernels run on CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")


def _split_weight(lib, weight: torch.Tensor, transpose: bool, stream: int) -> tuple:
    """The weight's hi and lo halves (2, rows, ld) as the product reads them:
    W (N, K) for the forward, Wᵀ (K, N) for the input gradient, each row
    zero-padded to a multiple of 4 floats."""
    n, k = weight.shape
    rows, cols = (k, n) if transpose else (n, k)
    ld = (cols + 3) // 4 * 4
    halves = torch.empty((2, rows, ld), dtype=torch.float32, device=weight.device)
    w = weight.contiguous()
    _raise_on(lib, "split", lib.linear_tf32x3_split(w.data_ptr(), n, k, int(transpose),
                                                    halves.data_ptr(), ld, stream))
    return halves, ld


def _mm(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
        transpose: bool) -> torch.Tensor:
    """``a @ weight.T + bias`` (forward) or ``a @ weight`` (transpose: the
    input gradient) for a contiguous (M, ·) float32 matrix on the card; a
    half weight promoted, the products with its zero lo half left out."""
    m = a.shape[0]
    n = weight.shape[1] if transpose else weight.shape[0]
    check_shape(m, n, a.shape[1])
    lib = _library()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        halves, ld = _split_weight(lib, weight.float(), transpose, stream)
        err = lib.linear_tf32x3_mm(a.data_ptr(), m, a.shape[1], a.stride(0), halves.data_ptr(),
                                   n, ld, None if bias is None else bias.data_ptr(),
                                   out.data_ptr(), int(weight.dtype != torch.float32), stream)
    _raise_on(lib, "dgrad" if transpose else "forward", err)
    return out


def linear_fwd(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the forward on CUDA float32 tensors (the weight float32, bf16
    or fp16): ``x @ weight.T + bias`` over x's last dim.  Adds one to
    ``rgbnm.launch.linear_tf32x3_fwd``."""
    _check_inputs(x, weight, bias)
    _on_cuda(x)
    b = None if bias is None else bias.contiguous()
    out = _mm(_rows(x), weight, b, transpose=False)
    profiling.count("rgbnm.launch.linear_tf32x3_fwd")
    return out.reshape(*x.shape[:-1], weight.shape[0])


def linear_dgrad(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch the input gradient on CUDA float32 tensors (the weight
    float32, bf16 or fp16): ``dy @ weight`` over dy's last dim.  Adds one to
    ``rgbnm.launch.linear_tf32x3_dgrad``."""
    _on_cuda(dy, weight)
    if (dy.dtype != torch.float32 or weight.dtype not in _WEIGHT_DTYPES
            or dy.device != weight.device):
        raise TypeError(f"linear_dgrad takes float32 on one device, got {dy.dtype} on "
                        f"{dy.device}, {weight.dtype} on {weight.device}")
    if weight.dim() != 2 or dy.shape[-1] != weight.shape[0]:
        raise ValueError(f"dy {tuple(dy.shape)} and weight {tuple(weight.shape)} do not match")
    out = _mm(_rows(dy), weight, None, transpose=True)
    profiling.count("rgbnm.launch.linear_tf32x3_dgrad")
    return out.reshape(*dy.shape[:-1], weight.shape[1])


def linear_wgrad(dy: torch.Tensor, x: torch.Tensor, bias: bool = True):
    """Launch the weight gradient on CUDA float32 tensors: ``(dW, db)`` with
    dW = dyᵀ x over the rows of both (every dim but the last) and db = the
    column sums of dy, or None without ``bias``; both repeat bit for bit
    (M dealt out across the SMs, the parts added in a fixed order).  Adds one
    to ``rgbnm.launch.linear_tf32x3_wgrad``."""
    _on_cuda(dy, x)
    if dy.dtype != torch.float32 or x.dtype != torch.float32 or dy.device != x.device:
        raise TypeError(f"linear_wgrad takes float32 on one device, got {dy.dtype} on "
                        f"{dy.device}, {x.dtype} on {x.device}")
    dy2, x2 = _rows(dy), _rows(x)
    m, n, k = dy2.shape[0], dy2.shape[1], x2.shape[1]
    if x2.shape[0] != m:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ in rows")
    check_shape(m, n, k)
    lib = _library()
    dw = torch.empty((n, k), dtype=torch.float32, device=x.device)
    db = torch.empty((n,), dtype=torch.float32, device=x.device) if bias else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # each block's part of each dW tile it takes, before the fixed-order sum
        scratch = torch.empty(lib.linear_tf32x3_wgrad_scratch(m, n, k, int(bias)),
                              dtype=torch.float32, device=x.device)
        err = lib.linear_tf32x3_wgrad(dy2.data_ptr(), dy2.stride(0), x2.data_ptr(),
                                      x2.stride(0), m, n, k, dw.data_ptr(),
                                      None if db is None else db.data_ptr(),
                                      scratch.data_ptr(), stream)
    _raise_on(lib, "wgrad", err)
    profiling.count("rgbnm.launch.linear_tf32x3_wgrad")
    return dw, db


class _LinearTF32x3(torch.autograd.Function):
    """The kernels on CUDA tensors; :func:`mm_tf32x3` on CPU tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if x.device.type == "cpu":
            return linear_plain(x, weight, bias)
        return linear_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if dy.device.type == "cpu":
            dy2 = _rows(dy)
            if need_x:
                dx = mm_tf32x3(dy2, weight.float().T.contiguous()).reshape(x.shape)
            if need_w:
                dw = mm_tf32x3(dy2.T.contiguous(), _rows(x).T.contiguous())
            if need_b:
                db = dy2.sum(0)
        else:
            if need_x:
                dx = linear_dgrad(dy, weight).reshape(x.shape)
            if need_w or need_b:
                dw, db = linear_wgrad(dy, x, bias=ctx.has_bias)
                dw = dw if need_w else None
                db = db if need_b else None
        return dx, None if dw is None else dw.to(weight.dtype), db


def linear_tf32x3(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear(x, weight.float(), bias)`` for float32 x and bias and a
    float32, bf16 or fp16 weight, differentiable in all three: the 3xTF32
    kernels on CUDA tensors (a shape or layout they refuse raises; a half
    weight's zero lo half left out), :func:`mm_tf32x3` on CPU tensors."""
    _check_inputs(x, weight, bias)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if x.device.type == "cuda" and not grad:  # eval: nothing saved
        return linear_fwd(x, weight, bias)
    return _LinearTF32x3.apply(x, weight, bias)
