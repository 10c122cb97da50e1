"""Fused DCT input stage — flip + RandAugment + ToRange: the CUDA kernel's
wrapper and its plain version.

Port of ``rgbnomore_tpu/ops/pallas/augpipe.py``.  ``fused_flip_aug_range(y,
c, policy, flip, *, ops_list, num_ops, magnitude, num_bins=11)`` keeps the
JAX call contract: ``y`` (B, 1, H, W, 8, 8) and ``c`` (B, 2, H/2, W/2, 8, 8)
float32 dequantized coefficients, ``policy`` the
``RandAugmentDCT.draw_policy`` tuple, ``flip`` (B,) bool; it returns (y, c)
in the same shapes, rescaled to [-1, 1].  On CUDA tensors it launches
``csrc/augpipe.cu`` or raises; on CPU tensors it runs
:func:`flip_aug_range_plain` (flip -> clamp -> the rounds of
``RandAugmentDCT.apply`` -> ``to_range``), the counterpart of ``_ref_apply``
in ``tests/test_pallas_augpipe.py`` that the tests and ``chip_smoke.py``
hold the kernel against.

The per-op constants (op codes, translate shifts, cutout sizes, posterize
step and levels, the Sharpness / MidfreqAug filter rows) are built on the
host, as the JAX kernel builds its filter table (``_make_branches``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.randaugment import (
    RandAugmentDCT,
    _magnitude_table,
    cutout_size,
    translate_blocks,
)
from rgbnomore_tpu_torch.ops import cuda_build
from rgbnomore_tpu_torch.ops.photometric import DCT_MAX, DCT_MIN

__all__ = ["SUPPORTED_OPS", "OP_CODES", "flip_aug_range_plain", "fused_flip_aug_range",
           "op_tables"]

# the kernel's op set, and each op's code in csrc/augpipe.cu (enum OpCode)
OP_CODES = {name: i for i, name in enumerate((
    "Identity", "AutoContrast", "AutoSaturation", "Posterize", "SolarizeAdd",
    "Color", "Contrast", "Brightness", "Sharpness", "MidfreqAug", "Cutout",
    "TranslateX", "TranslateY", "Rotate90", "Grayscale", "ChromaDrop"))}
SUPPORTED_OPS = frozenset(OP_CODES)
_MAX_ROUNDS = 4  # the kernel is instantiated for 0..4 rounds


def _midfreq_filters(mag: float) -> np.ndarray:
    """(2, 64) filters for sign +1 / -1, pre-composed with the block shift:
    ``midfreqaug_dct`` is roll -> multiply by the gaussian filter -> clamp ->
    roll back, and the clamp commutes with the rolls, so the op is
    ``clamp(x * filt[(i+4)%8, (j+4)%8])``."""
    out = np.empty((2, 64), np.float32)
    for s_i, sign in enumerate((1.0, -1.0)):
        intensity = mag * sign
        std = 4.0 - 2.2 * abs(intensity)
        i = np.arange(8.0) - 3.5
        g = np.exp(-0.5 * np.square(i / std))
        filt = g[:, None] * g[None, :]
        filt = 1.0 / filt if intensity >= 0 else filt
        out[s_i] = np.roll(filt, (-4, -4), axis=(0, 1)).reshape(64)
    return out


def _sharp_filters(mag: float) -> np.ndarray:
    """(2, 64) sharpen/blur ramps for sign +1 / -1."""
    out = np.empty((2, 64), np.float32)
    for s_i, sign in enumerate((1.0, -1.0)):
        ramp = np.clip(1.0 + 2.0 * mag * sign * np.arange(8.0) / 7.0, 0.0, None)
        out[s_i] = (ramp[:, None] * ramp[None, :]).reshape(64)
    return out


def op_tables(ops_list, magnitude: int, num_bins: int, grid_h: int, grid_w: int):
    """The kernel's op table for ``ops_list``: codes (n,) int32, params
    (n, 4) float32 and filters (n, 2, 64) float32 (rows: sign +1 / -1; ones
    where the op has no filter).

    params by op: Posterize (step, levels); SolarizeAdd (addition,);
    Color / Contrast / Brightness (magnitude,); Cutout (luma half-width,
    chroma half-width); TranslateX/Y (luma shift for sign +1, for sign -1,
    chroma shift for sign +1, for sign -1).
    """
    unsupported = sorted(set(ops_list) - SUPPORTED_OPS)
    if unsupported:
        raise ValueError(f"the fused augmentation kernel does not support ops {unsupported}")
    table = _magnitude_table(num_bins, grid_h, grid_w)
    n = len(ops_list)
    codes = np.zeros(n, np.int32)
    params = np.zeros((n, 4), np.float32)
    filts = np.ones((n, 2, 64), np.float32)
    for i, name in enumerate(ops_list):
        mag = float(table[name][0][magnitude])
        codes[i] = OP_CODES[name]
        if name == "Posterize":
            step = 2.0 ** mag
            params[i, :2] = step, max(round((DCT_MAX - DCT_MIN) / step), 1.0)
        elif name == "SolarizeAdd":
            params[i, 0] = int(mag)
        elif name in ("Color", "Contrast", "Brightness"):
            params[i, 0] = mag
        elif name == "Cutout":
            size = cutout_size(mag)
            params[i, :2] = size, size // 2
        elif name in ("TranslateX", "TranslateY"):
            t_pos, t_neg = translate_blocks(mag)
            params[i] = t_pos, t_neg, t_pos // 2, t_neg // 2
        elif name == "Sharpness":
            filts[i] = _sharp_filters(mag)
        elif name == "MidfreqAug":
            filts[i] = _midfreq_filters(mag)
    return codes, params, filts


def flip_aug_range_plain(y: torch.Tensor, c: torch.Tensor, policy, flip: torch.Tensor, *,
                         ops_list, num_ops: int, magnitude: int, num_bins: int = 11):
    """Flip -> clamp -> ``num_ops`` rounds of ``RandAugmentDCT.apply`` ->
    ``to_range``, in plain PyTorch."""
    # imported here: augment/pipeline.py imports this module
    from rgbnomore_tpu_torch.augment.pipeline import random_flip, to_range

    aug = RandAugmentDCT(ops_list=list(ops_list), num_ops=num_ops, magnitude=magnitude,
                         num_magnitude_bins=num_bins, grid=y.shape[2])
    y, c = random_flip(y, c, flip)
    y, c = aug.apply(y, c, policy)
    return to_range(y), to_range(c)


def _check_inputs(y, c, policy, flip, ops_list, num_ops):
    if y.dim() != 6 or y.shape[1] != 1 or y.shape[-2:] != (8, 8):
        raise ValueError(f"y must be (B, 1, H, W, 8, 8), got {tuple(y.shape)}")
    b, _, h, w = y.shape[:4]
    if h % 2 or w % 2 or tuple(c.shape) != (b, 2, h // 2, w // 2, 8, 8):
        raise ValueError(f"c must be (B, 2, H/2, W/2, 8, 8) with even H, W; got "
                         f"{tuple(c.shape)} for y {tuple(y.shape)}")
    if y.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"y, c must be float32, got {y.dtype}, {c.dtype}")
    if y.device != c.device or y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"y, c on devices {y.device}, {c.device}")
    if len(policy) != 5 or any(tuple(p.shape) != (b, num_ops) for p in policy):
        raise ValueError(f"policy must be 5 arrays of shape (B, num_ops) = ({b}, {num_ops})")
    if tuple(flip.shape) != (b,):
        raise ValueError(f"flip must be (B,) = ({b},), got {tuple(flip.shape)}")
    if num_ops and not ops_list:
        raise ValueError("num_ops > 0 with an empty op list")
    if "Rotate90" in ops_list and h != w:
        raise ValueError(f"Rotate90 needs a square block grid, got {h}x{w}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("augpipe")
    if lib.augpipe_fwd.argtypes is None:  # first use: declare the C signature
        lib.augpipe_fwd.argtypes = [ctypes.c_void_p] * 13 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.augpipe_fwd.restype = ctypes.c_int
        lib.augpipe_error_string.argtypes = [ctypes.c_int]
        lib.augpipe_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=8)
def _device_tables(ops: tuple, magnitude: int, num_bins: int, h: int, w: int,
                   device: torch.device):
    """``op_tables`` on the device, built once per op list and grid."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in op_tables(ops, magnitude, num_bins, h, w))


def fused_flip_aug_range(y: torch.Tensor, c: torch.Tensor, policy, flip: torch.Tensor, *,
                         ops_list, num_ops: int, magnitude: int, num_bins: int = 11):
    """Apply flip + ``num_ops`` RandAugment rounds + ToRange in one pass.

    CPU tensors take :func:`flip_aug_range_plain`.  CUDA tensors launch the
    hand-written kernel on the current stream (at most 4 rounds) and add
    one to ``fused_flip_aug_range.launches``; a refused launch raises.
    """
    ops_list = list(ops_list)
    _check_inputs(y, c, policy, flip, ops_list, num_ops)
    if y.device.type == "cpu":
        return flip_aug_range_plain(y, c, policy, flip, ops_list=ops_list, num_ops=num_ops,
                                    magnitude=magnitude, num_bins=num_bins)
    if num_ops > _MAX_ROUNDS:
        raise ValueError(f"num_ops {num_ops} > {_MAX_ROUNDS} is not supported by the kernel")
    b, _, h, w = y.shape[:4]
    codes, params, filts = _device_tables(tuple(ops_list), magnitude, num_bins, h, w,
                                          y.device)
    dev = y.device
    idx, sign, cut_ch, cut_cw, drop = policy
    # the kernel indexes the op table with idx: a policy on the host (the
    # pipeline's) is checked there, at no device sync; one already on the
    # card is taken as ``draw_policy`` made it, in range by construction
    if num_ops and idx.device.type == "cpu" and \
            not bool(((idx >= 0) & (idx < len(ops_list))).all()):
        raise ValueError(f"policy op index outside the list of {len(ops_list)} ops")
    args = [t.to(device=dev, dtype=dt).contiguous() for t, dt in (
        (idx, torch.int32), (sign, torch.float32), (cut_ch, torch.int32),
        (cut_cw, torch.int32), (drop, torch.int32), (flip, torch.int32))]
    y, c = y.contiguous(), c.contiguous()
    yo, co = torch.empty_like(y), torch.empty_like(c)
    val_scale = 2.0 / (DCT_MAX - DCT_MIN)
    val_shift = -1.0 - DCT_MIN * val_scale
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.augpipe_fwd(y.data_ptr(), c.data_ptr(), yo.data_ptr(), co.data_ptr(),
                              *(a.data_ptr() for a in args), codes.data_ptr(),
                              params.data_ptr(), filts.data_ptr(), b, h, w, num_ops,
                              val_scale, val_shift, stream)
    if err != 0:
        msg = lib.augpipe_error_string(err).decode()
        raise RuntimeError(f"augpipe_fwd launch failed: {msg} (cudaError {err})")
    fused_flip_aug_range.launches += 1
    return yo, co


fused_flip_aug_range.launches = 0  # kernel launches since the count was last reset
