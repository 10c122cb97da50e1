"""The device half of the cropped DCT input pipelines, eval and train.

Port of the cropped-wire paths of ``rgbnomore_tpu/augment/pipeline.py``:
re-slice the consolidated ``(B, row)`` uint8 buffer into typed fields,
unpack the mask16 wire to dense dequantized coefficients, then for eval
rescale to [-1, 1], and for training run flip -> RandAugment -> ToRange.
On a CUDA buffer each stage is one launch of the CUDA kernel's wire reader,
which reads the rows itself (``ops.augpipe.wire_to_range`` for eval,
``ops.augpipe.wire_flip_aug_range`` for training); on a CPU buffer the
split, the unpack and the rest run as plain tensor code.  For the same row
buffer the eval outputs are bit-exact against the JAX pipeline
(``tests/test_torch_port_eval.py``, ``tests/test_torch_port_wire.py``) and
the train outputs within 2e-6 of it with the same draws
(``tests/test_torch_port_augment.py``, ``tests/test_torch_port_wire.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
from rgbnomore_tpu_torch.data.loader import packed_layout
from rgbnomore_tpu_torch.ops import blocks
from rgbnomore_tpu_torch.ops.augpipe import wire_flip_aug_range, wire_to_range
from rgbnomore_tpu_torch.ops.photometric import DCT_MAX, DCT_MIN

__all__ = [
    "DCT_MIN",
    "DCT_MAX",
    "dequantize",
    "split_packed_batch",
    "unpack_coefficients_mask",
    "unpack_fields",
    "unpack_cropped",
    "to_range",
    "random_flip",
    "make_cropped_eval_pipeline",
    "make_cropped_train_pipeline",
    "CroppedTrainPipeline",
]

_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def split_packed_batch(packed: torch.Tensor, canvas: int, k: int, fmt: str = "mask16",
                       names=None) -> dict[str, torch.Tensor]:
    """Re-slice the consolidated (B, row) uint8 buffer into typed fields
    (only ``names`` where given).

    Inverse of the host-side layout (``data.loader.packed_layout``): each
    field is a byte slice of every row reinterpreted in place with
    ``Tensor.view(dtype)``.  Field offsets and the row length are multiples
    of 4, so every slice is aligned for its dtype and no bytes are copied.
    """
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed rows must be (B, row) uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    layout = packed_layout(canvas, k, fmt)
    if packed.shape[1] != layout["row"]:
        raise ValueError(f"row is {packed.shape[1]} bytes, layout wants {layout['row']}")
    b = packed.shape[0]
    out = {}
    for name, spec in layout.items():
        if name == "row" or (names is not None and name not in names):
            continue
        off, shape, dtype = spec
        n = int(np.prod(shape, dtype=np.int64))
        sl = packed[:, off : off + n * dtype.itemsize]
        out[name] = sl.view(_TORCH_DTYPES[dtype]).reshape((b,) + shape)
    return out


def unpack_coefficients_mask(values: torch.Tensor, mask: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Decompress bitmask-packed blocks to dense coefficients.

    ``values`` (..., H, W, K) int8/int16 in ascending-position order,
    ``mask`` (..., H, W, 8) uint8 little-endian occupancy bits (bit ``p & 7``
    of byte ``p >> 3`` <=> position ``p`` kept), ``scales`` (..., H, W) uint8.
    The value for set position ``p`` sits at rank = popcount(mask below p),
    an exclusive prefix-sum of the bits.  The JAX version selects it with a
    compare-and-reduce over the K slots; here it is a gather of the same
    value, so the result is identical without the (..., 64, K) intermediate.
    A set bit of rank K or more has no slot: the JAX compare finds none and
    gives 0, and so does this.  Returns (..., H, W, 8, 8) float32.
    """
    k = values.shape[-1]
    bit_sel = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=mask.device)
    bits = (mask[..., None] & bit_sel) != 0  # (..., 8, 8) bytes x bits
    bits = bits.reshape(bits.shape[:-2] + (64,)).to(torch.int32)
    ranks = torch.cumsum(bits, dim=-1) - bits  # exclusive prefix sum, (..., 64)
    vals = values.to(torch.float32) * scales[..., None].to(torch.float32)
    dense = torch.gather(vals, -1, ranks.clamp(max=k - 1).to(torch.int64))
    dense = dense * ((bits != 0) & (ranks < k)).to(torch.float32)
    return dense.reshape(dense.shape[:-1] + (8, 8))


def unpack_fields(f: dict, fmt: str):
    """Decompress a split mask16 batch to dense (y, c) coefficients with the
    exact int16 DC plane written into position (0, 0)."""
    y = unpack_coefficients_mask(f["vy"], f["iy"], f["sy"])
    c = unpack_coefficients_mask(f["vc"], f["ic"], f["sc"])
    y[..., 0, 0] = f["dy"].to(torch.float32)
    c[..., 0, 0] = f["dc"].to(torch.float32)
    return y, c


def dequantize(y_q: torch.Tensor, c_q: torch.Tensor, quant: torch.Tensor):
    """Dequantize coefficient canvases with per-sample quant tables.

    ``y_q`` (B, 1, H, W, 8, 8), ``c_q`` (B, 2, H/2, W/2, 8, 8), ``quant``
    (B, 3, 8, 8) int16.  Multiplies and clamps to [-1024, 1016] as the
    reference loader does (``datasets.py:286-297``).
    """
    qy = quant[:, 0:1, None, None].to(torch.float32)
    qc = quant[:, 1:3, None, None].to(torch.float32)
    y = torch.clamp(y_q.to(torch.float32) * qy, DCT_MIN, DCT_MAX)
    c = torch.clamp(c_q.to(torch.float32) * qc, DCT_MIN, DCT_MAX)
    return y, c


def unpack_cropped(f: dict, fmt: str):
    """Unpack a crop-before-pack wire to DEQUANTIZED coefficients.

    ``mask16``/``mask16w`` carry dequantized values directly; ``mask16q``
    carries JPEG quantized-unit integers and is multiplied back by the
    per-sample quant table here.
    """
    y, c = unpack_fields(f, fmt)
    if fmt == "mask16q":
        y, c = dequantize(y, c, f["quant"])
    return y, c


def to_range(x: torch.Tensor, val_min: float = -1.0, val_max: float = 1.0,
             orig_min: float = DCT_MIN, orig_max: float = DCT_MAX) -> torch.Tensor:
    """Affine rescale (``custom_transforms.py:406-466``).

    Keeps the JAX order of operations — normalise to [0, 1], then stretch —
    so the result is bit-exact against it.  The divisor is a 0-d tensor on
    the input's device: CUDA divides by a host scalar as a multiply by its
    reciprocal, which rounds differently from a true division.
    """
    span = torch.full((), orig_max - orig_min, dtype=torch.float32, device=x.device)
    x = (x.to(torch.float32) - orig_min) / span
    return val_min + x * (val_max - val_min)


def random_flip(y: torch.Tensor, c: torch.Tensor, flip: torch.Tensor):
    """Horizontal flip of the samples whose ``flip`` bit is set
    (``custom_transforms.py:913-942``); the bits are drawn by the caller."""
    sel = flip.to(device=y.device, dtype=torch.bool).reshape(-1, 1, 1, 1, 1, 1)
    return (torch.where(sel, blocks.flip_dct(y, "horizontal"), y),
            torch.where(sel, blocks.flip_dct(c, "horizontal"), c))


def make_cropped_eval_pipeline(cfg=None, *, target: int = 28, k: int = 16,
                               fmt: str = "mask16") -> Callable:
    """Eval pipeline for the crop-before-pack wire: the host already did the
    deterministic center crop, so the device only unpacks and rescales
    (``wire_to_range``: one kernel launch on a CUDA buffer).
    ``fn(packed_buf) -> (y, cbcr, labels, weights)``."""
    if cfg is not None:
        target = cfg.model.dct_blocks

    def pipeline(packed_buf: torch.Tensor):
        f = split_packed_batch(packed_buf, target, k, fmt, names=("labels", "weights"))
        y, c = wire_to_range(packed_buf, target=target, k=k, fmt=fmt)
        return y, c, f["labels"], f["weights"]

    return pipeline


class CroppedTrainPipeline:
    """Train pipeline for the crop-before-pack wire (``DctCroppedLoader``).

    The host already dequantized, cropped and resized to the target grid, so
    the device path is unpack -> flip -> RandAugment -> ToRange, all four in
    one ``wire_flip_aug_range`` (one launch of the CUDA kernel on a CUDA
    buffer, its plain version on a CPU one).  ``pipe(packed, flip, policy) -> (y,
    cbcr, labels, weights)`` takes the draws explicitly; ``pipe.draw(
    generator, batch)`` makes them, as the JAX pipeline does from its key
    (``pipeline.py:384-389``).
    """

    def __init__(self, target: int, ops_list, num_ops: int, magnitude: int, k: int,
                 fmt: str):
        self.target, self.k, self.fmt = target, k, fmt
        self.ops_list, self.num_ops, self.magnitude = list(ops_list), num_ops, magnitude
        self.aug = RandAugmentDCT(ops_list=self.ops_list, num_ops=num_ops,
                                  magnitude=magnitude, grid=target)

    def draw(self, generator: torch.Generator, batch: int):
        """``(flip (B,) bool, policy)`` on the generator's device: each
        sample flips with probability 1/2, then ``draw_policy``."""
        flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return flip, self.aug.draw_policy(generator, batch, self.target, self.target)

    def __call__(self, packed_buf: torch.Tensor, flip: torch.Tensor, policy):
        f = split_packed_batch(packed_buf, self.target, self.k, self.fmt,
                               names=("labels", "weights"))
        y, c = wire_flip_aug_range(packed_buf, flip, policy, target=self.target, k=self.k,
                                   fmt=self.fmt, ops_list=self.ops_list,
                                   num_ops=self.num_ops, magnitude=self.magnitude)
        return y, c, f["labels"], f["weights"]


def make_cropped_train_pipeline(cfg=None, *, target: int = 28, auglist=None,
                                num_ops: int = 2, magnitude: int = 3, k: int = 16,
                                fmt: str = "mask16") -> CroppedTrainPipeline:
    """The cropped-wire train pipeline; ``cfg`` supplies the grid, the op
    list, the number of rounds and the magnitude."""
    if cfg is not None:
        target = cfg.model.dct_blocks
        auglist = list(cfg.train.auglist)
        num_ops = cfg.train.num_ops
        magnitude = cfg.train.augstr
    return CroppedTrainPipeline(target, list(auglist or []), num_ops, magnitude, k, fmt)
