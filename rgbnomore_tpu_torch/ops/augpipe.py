"""Fused DCT input stage — flip + RandAugment + ToRange: the CUDA kernel's
wrappers and their plain versions.

Port of ``rgbnomore_tpu/ops/pallas/augpipe.py``.  ``csrc/augpipe.cu`` has one
core with two readers, and each has its wrapper here:

- ``fused_flip_aug_range(y, c, policy, flip, *, ops_list, num_ops,
  magnitude, num_bins=11)`` keeps the JAX call contract: ``y`` (B, 1, H, W,
  8, 8) and ``c`` (B, 2, H/2, W/2, 8, 8) float32 dequantized coefficients,
  ``policy`` the ``RandAugmentDCT.draw_policy`` tuple, ``flip`` (B,) bool; it
  returns (y, c) in the same shapes, rescaled to [-1, 1].  Its plain version
  :func:`flip_aug_range_plain` (flip -> clamp -> the rounds of
  ``RandAugmentDCT.apply`` -> ``to_range``) is the counterpart of
  ``_ref_apply`` in ``tests/test_pallas_augpipe.py``.
- ``wire_flip_aug_range(packed, flip, policy, *, target, k, fmt, ...)`` reads
  the consolidated (B, row) uint8 rows of the mask16 wire itself: the JAX
  train pipeline's ``unpack_cropped -> fused_flip_aug_range`` in one launch
  (plain: :func:`wire_flip_aug_range_plain`).  ``wire_to_range(packed, *,
  target, k, fmt)`` is the eval stage, ``unpack_cropped -> to_range``, bit-
  exact against both (plain: :func:`wire_to_range_plain`).

On CUDA tensors a wrapper launches the kernel on the current stream, adds
one to its ``.launches`` and raises if the launch is refused; on CPU tensors
it runs its plain version, which the tests and ``chip_smoke.py`` hold the
kernel against.  The train pipelines also call the plain versions directly,
on either device, for an op list with an op outside ``SUPPORTED_OPS``
(``augment/pipeline.py``): the kernel takes 16 of the 23 ops.  The per-op constants (op codes, translate shifts, cutout
sizes, posterize step and levels, the Sharpness / MidfreqAug filter rows) are
built on the host, as the JAX kernel builds its filter table
(``_make_branches``).
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
from rgbnomore_tpu_torch.data.loader import packed_layout
from rgbnomore_tpu_torch.ops import cuda_build
from rgbnomore_tpu_torch.ops.photometric import DCT_MAX, DCT_MIN

__all__ = ["SUPPORTED_OPS", "OP_CODES", "WIRE_FORMATS", "flip_aug_range_plain",
           "fused_flip_aug_range", "op_tables", "wire_flip_aug_range",
           "wire_flip_aug_range_plain", "wire_to_range", "wire_to_range_plain"]

# the kernel's op set, and each op's code in csrc/augpipe.cu (enum OpCode)
OP_CODES = {name: i for i, name in enumerate((
    "Identity", "AutoContrast", "AutoSaturation", "Posterize", "SolarizeAdd",
    "Color", "Contrast", "Brightness", "Sharpness", "MidfreqAug", "Cutout",
    "TranslateX", "TranslateY", "Rotate90", "Grayscale", "ChromaDrop"))}
SUPPORTED_OPS = frozenset(OP_CODES)
# the wire formats the wire reader takes, and their codes (enum WireFmt)
WIRE_FORMATS = {"mask16": 0, "mask16w": 1, "mask16q": 2}
# the row fields the wire reader reads, in the order of its layout array
_WIRE_FIELDS = ("vy", "iy", "sy", "vc", "ic", "sc", "quant", "dy", "dc")
_MAX_ROUNDS = 4  # the kernel is instantiated for 0..4 rounds
# ToRange(-1, 1) from [DCT_MIN, DCT_MAX] as one multiply-add (the TPU kernel's form)
_VAL_SCALE = 2.0 / (DCT_MAX - DCT_MIN)
_VAL_SHIFT = -1.0 - DCT_MIN * _VAL_SCALE


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


def _unpack_plain(packed: torch.Tensor, target: int, k: int, fmt: str):
    from rgbnomore_tpu_torch.augment.pipeline import split_packed_batch, unpack_cropped

    return unpack_cropped(split_packed_batch(packed, target, k, fmt), fmt)


def wire_flip_aug_range_plain(packed: torch.Tensor, flip: torch.Tensor, policy, *, target: int,
                              k: int, fmt: str, ops_list, num_ops: int, magnitude: int,
                              num_bins: int = 11):
    """``split_packed_batch -> unpack_cropped -> flip_aug_range_plain``."""
    y, c = _unpack_plain(packed, target, k, fmt)
    return flip_aug_range_plain(y, c, policy, flip, ops_list=ops_list, num_ops=num_ops,
                                magnitude=magnitude, num_bins=num_bins)


def wire_to_range_plain(packed: torch.Tensor, *, target: int, k: int, fmt: str):
    """``split_packed_batch -> unpack_cropped -> to_range``."""
    from rgbnomore_tpu_torch.augment.pipeline import to_range

    y, c = _unpack_plain(packed, target, k, fmt)
    return to_range(y), to_range(c)


def _check_policy(policy, flip, b: int, h: int, w: int, ops_list, num_ops: int):
    if len(policy) != 5 or any(tuple(p.shape) != (b, num_ops) for p in policy):
        raise ValueError(f"policy must be 5 arrays of shape (B, num_ops) = ({b}, {num_ops})")
    if tuple(flip.shape) != (b,):
        raise ValueError(f"flip must be (B,) = ({b},), got {tuple(flip.shape)}")
    if num_ops and not ops_list:
        raise ValueError("num_ops > 0 with an empty op list")
    if "Rotate90" in ops_list and h != w:
        raise ValueError(f"Rotate90 needs a square block grid, got {h}x{w}")


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
    _check_policy(policy, flip, b, h, w, ops_list, num_ops)


def _check_wire(packed: torch.Tensor, target: int, k: int, fmt: str) -> dict:
    """The row layout of a valid (B, row) uint8 buffer of the wire."""
    if fmt not in WIRE_FORMATS:
        raise ValueError(f"the wire reader takes {sorted(WIRE_FORMATS)}, not {fmt!r}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed rows must be (B, row) uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed rows on device {packed.device}")
    layout = packed_layout(target, k, fmt)
    if packed.shape[1] != layout["row"]:
        raise ValueError(f"row is {packed.shape[1]} bytes, layout wants {layout['row']}")
    return layout


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("augpipe")
    if lib.augpipe_fwd.argtypes is None:  # first use: declare the C signatures
        lib.augpipe_fwd.argtypes = [ctypes.c_void_p] * 13 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.augpipe_fwd.restype = ctypes.c_int
        lib.augpipe_wire.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.augpipe_wire.restype = ctypes.c_int
        lib.augpipe_error_string.argtypes = [ctypes.c_int]
        lib.augpipe_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.augpipe_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (cudaError {err})")


@functools.lru_cache(maxsize=8)
def _device_tables(ops: tuple, magnitude: int, num_bins: int, h: int, w: int,
                   device: torch.device):
    """``op_tables`` on the device, built once per op list and grid."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in op_tables(ops, magnitude, num_bins, h, w))


def _device_policy(policy, flip, ops_list, num_ops: int, magnitude: int, num_bins: int,
                   h: int, w: int, dev: torch.device) -> tuple[torch.Tensor, list[int]]:
    """The kernel's policy arguments on the device, as one int32 tensor (one
    copy from the host) and the addresses of its parts: idx, sign (its
    float32 bits), cut_ch, cut_cw, drop, flip; then the addresses of the op
    table's codes, params and filters.  Keep the tensor alive until the
    launch is enqueued."""
    if num_ops > _MAX_ROUNDS:
        raise ValueError(f"num_ops {num_ops} > {_MAX_ROUNDS} is not supported by the kernel")
    idx, sign, cut_ch, cut_cw, drop = policy
    # the kernel indexes the op table with idx: a policy on the host (the
    # pipeline's) is checked there, at no device sync; one already on the
    # card is taken as ``draw_policy`` made it, in range by construction
    if num_ops and idx.device.type == "cpu" and \
            not bool(((idx >= 0) & (idx < len(ops_list))).all()):
        raise ValueError(f"policy op index outside the list of {len(ops_list)} ops")
    parts = [idx.to(torch.int32), sign.to(torch.float32).contiguous().view(torch.int32),
             cut_ch.to(torch.int32), cut_cw.to(torch.int32), drop.to(torch.int32),
             flip.to(torch.int32)]
    if any(t.device != dev for t in parts) and any(t.device == dev for t in parts):
        parts = [t.to(dev) for t in parts]  # mixed: join them on the card
    args = torch.cat([t.reshape(-1) for t in parts]).to(dev)
    sizes = [t.numel() for t in parts]
    ptrs = [args.data_ptr() + 4 * int(off) for off in np.cumsum([0] + sizes[:-1])]
    tables = _device_tables(tuple(ops_list), magnitude, num_bins, h, w, dev)
    return args, ptrs + [t.data_ptr() for t in tables]


def fused_flip_aug_range(y: torch.Tensor, c: torch.Tensor, policy, flip: torch.Tensor, *,
                         ops_list, num_ops: int, magnitude: int, num_bins: int = 11):
    """Apply flip + ``num_ops`` RandAugment rounds + ToRange in one pass.

    CPU tensors take :func:`flip_aug_range_plain`.  CUDA tensors launch the
    hand-written kernel's dense reader on the current stream (at most 4
    rounds) and add one to ``fused_flip_aug_range.launches``; a refused
    launch raises.
    """
    ops_list = list(ops_list)
    _check_inputs(y, c, policy, flip, ops_list, num_ops)
    if y.device.type == "cpu":
        return flip_aug_range_plain(y, c, policy, flip, ops_list=ops_list, num_ops=num_ops,
                                    magnitude=magnitude, num_bins=num_bins)
    b, _, h, w = y.shape[:4]
    args, ptrs = _device_policy(policy, flip, ops_list, num_ops, magnitude, num_bins, h, w,
                                y.device)
    # the kernel reads four neighbours as one 16-byte load
    y, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (y.contiguous(), c.contiguous()))
    yo, co = torch.empty_like(y), torch.empty_like(c)
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.augpipe_fwd(y.data_ptr(), c.data_ptr(), yo.data_ptr(), co.data_ptr(), *ptrs,
                              b, h, w, num_ops, _VAL_SCALE, _VAL_SHIFT, stream)
    _raise_on(lib, "augpipe_fwd", err)
    fused_flip_aug_range.launches += 1
    return yo, co


def _launch_wire(packed: torch.Tensor, layout: dict, target: int, k: int, fmt: str,
                 ptrs=None, num_ops: int = 0):
    """The wire reader on a CUDA buffer: the train stage with the policy
    addresses ``ptrs`` (``_device_policy``), or the eval stage without."""
    packed = packed.contiguous()
    if packed.data_ptr() % 4:
        raise ValueError("packed rows must start at a 4-byte aligned address")
    b, dev = packed.shape[0], packed.device
    yo = torch.empty((b, 1, target, target, 8, 8), dtype=torch.float32, device=dev)
    co = torch.empty((b, 2, target // 2, target // 2, 8, 8), dtype=torch.float32, device=dev)
    offsets = (ctypes.c_int * 10)(layout["row"], *(layout[f][0] for f in _WIRE_FIELDS))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.augpipe_wire(packed.data_ptr(), yo.data_ptr(), co.data_ptr(), offsets, k,
                               WIRE_FORMATS[fmt], int(ptrs is not None),
                               *(ptrs or [None] * 9), b, target, num_ops, _VAL_SCALE,
                               _VAL_SHIFT, stream)
    _raise_on(lib, "augpipe_wire", err)
    return yo, co


def wire_flip_aug_range(packed: torch.Tensor, flip: torch.Tensor, policy, *, target: int,
                        k: int, fmt: str, ops_list, num_ops: int, magnitude: int,
                        num_bins: int = 11):
    """Unpack the (B, row) uint8 rows of the ``fmt`` wire (``packed_layout(
    target, k, fmt)``) and apply flip + ``num_ops`` RandAugment rounds +
    ToRange: (y (B, 1, T, T, 8, 8), c (B, 2, T/2, T/2, 8, 8)) float32 in
    [-1, 1], T = ``target``.

    A CPU buffer takes :func:`wire_flip_aug_range_plain`.  A CUDA buffer
    launches the kernel's wire reader on the current stream, one launch for
    the whole stage, and adds one to ``wire_flip_aug_range.launches``; a
    refused launch raises.
    """
    ops_list = list(ops_list)
    layout = _check_wire(packed, target, k, fmt)
    _check_policy(policy, flip, packed.shape[0], target, target, ops_list, num_ops)
    if packed.device.type == "cpu":
        return wire_flip_aug_range_plain(packed, flip, policy, target=target, k=k, fmt=fmt,
                                         ops_list=ops_list, num_ops=num_ops,
                                         magnitude=magnitude, num_bins=num_bins)
    args, ptrs = _device_policy(policy, flip, ops_list, num_ops, magnitude, num_bins, target,
                                target, packed.device)
    out = _launch_wire(packed, layout, target, k, fmt, ptrs, num_ops)
    del args  # enqueued: the policy's memory may go back to the allocator
    wire_flip_aug_range.launches += 1
    return out


def wire_to_range(packed: torch.Tensor, *, target: int, k: int, fmt: str):
    """Unpack the (B, row) uint8 rows of the ``fmt`` wire and rescale to
    [-1, 1] in ``to_range``'s order: the eval stage, bit-exact against
    :func:`wire_to_range_plain` and the JAX pipeline.

    A CPU buffer takes :func:`wire_to_range_plain`.  A CUDA buffer launches
    the kernel's wire reader on the current stream and adds one to
    ``wire_to_range.launches``; a refused launch raises.
    """
    layout = _check_wire(packed, target, k, fmt)
    if packed.device.type == "cpu":
        return wire_to_range_plain(packed, target=target, k=k, fmt=fmt)
    out = _launch_wire(packed, layout, target, k, fmt)
    wire_to_range.launches += 1
    return out


# kernel launches since the count was last reset, per wrapper
fused_flip_aug_range.launches = 0
wire_flip_aug_range.launches = 0
wire_to_range.launches = 0
