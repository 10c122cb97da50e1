"""The device half of the input pipelines, eval and train, DCT and RGB.

Port of ``rgbnomore_tpu/augment/pipeline.py``.

The full-canvas transfers (``make_train_pipeline``, ``make_eval_pipeline``;
the JAX Trainer's ``transfer="packed"`` and ``"dense"``) take the packed
rows of ``DctPackedLoader`` (mask, index or mask16 format) or the dense
int16 canvases of ``DctCanvasLoader``, then unpack -> dequantize -> crop on
the device: for training a random resized crop (``augment/crops.py``) ->
flip + RandAugment + ToRange, which on a CUDA tensor is one launch of the
kernel's dense entry (``ops.augpipe.fused_flip_aug_range``); for eval the
center crop (ViT) or the whole-image resize (SwinV2) -> ToRange.

The cropped transfer (``make_cropped_*_pipeline``): re-slice the
consolidated ``(B, row)`` uint8 buffer into typed fields, unpack the mask16
wire to dense dequantized coefficients, then for eval
rescale to [-1, 1], and for training run flip -> RandAugment -> ToRange.
On a CUDA buffer each stage is one launch of the CUDA kernel's wire reader,
which reads the rows itself (``ops.augpipe.wire_to_range`` for eval,
``ops.augpipe.wire_flip_aug_range`` for training); on a CPU buffer the
split, the unpack and the rest run as plain tensor code.  For the same row
buffer the eval outputs are bit-exact against the JAX pipeline
(``tests/test_torch_port_eval.py``, ``tests/test_torch_port_wire.py``) and
the train outputs within 2e-6 of it with the same draws
(``tests/test_torch_port_augment.py``, ``tests/test_torch_port_wire.py``).

The RGB domain (``--domain rgb``) ships coefficients too and decodes them to
pixels on the device (``ops.pixel_decode``): the cropped wire
(``RgbCroppedLoader``'s K=63 mask16 rows of the crop box's window) through
``make_rgb_cropped_train_pipeline`` (decode -> the residual box's
bilinear resample -> flip -> ``RandAugmentRGB`` -> [-1, 1]) and
``make_rgb_cropped_eval_pipeline``; the full-canvas transfers through
``RgbCanvasPipeline`` (packed rows decoded by ``make_packed_rgb_decode``, or
the dense pixel canvases of ``RgbCanvasLoader``, then ``augment.rgb``'s
train or eval pipeline).  Every stage is tensor code on the rows' device:
no kernel of the port takes part, as none of the JAX package's does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.crops import (
    make_center_crop_resize,
    make_full_resize,
    make_random_resized_crop,
)
from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
from rgbnomore_tpu_torch.augment.rgb import (
    RandAugmentRGB,
    apply_separable_rgb,
    flip_images,
    make_rgb_eval_pipeline,
    make_rgb_train_pipeline,
    resample_matrix,
    to_unit_range,
)
from rgbnomore_tpu_torch.data.loader import packed_layout
from rgbnomore_tpu_torch.ops import blocks
from rgbnomore_tpu_torch.ops.augpipe import (
    SUPPORTED_OPS,
    flip_aug_range_plain,
    fused_flip_aug_range,
    wire_flip_aug_range,
    wire_flip_aug_range_plain,
    wire_to_range,
)
from rgbnomore_tpu_torch.ops.photometric import DCT_MAX, DCT_MIN
from rgbnomore_tpu_torch.ops.pixel_decode import decode_rgb_pixels

__all__ = [
    "DCT_MIN",
    "DCT_MAX",
    "dequantize",
    "split_packed_batch",
    "unpack_coefficients",
    "unpack_coefficients_mask",
    "unpack_fields",
    "unpack_cropped",
    "to_range",
    "random_flip",
    "make_cropped_eval_pipeline",
    "make_cropped_train_pipeline",
    "make_eval_pipeline",
    "make_train_pipeline",
    "CroppedTrainPipeline",
    "TrainPipeline",
    "RgbCanvasPipeline",
    "RgbCroppedTrainPipeline",
    "make_packed_rgb_decode",
    "make_rgb_cropped_eval_pipeline",
    "make_rgb_cropped_train_pipeline",
]

_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def split_packed_batch(packed: torch.Tensor, canvas: int, k: int, fmt: str = "mask16",
                       names=None, geom: bool = False) -> dict[str, torch.Tensor]:
    """Re-slice the consolidated (B, row) uint8 buffer into typed fields
    (only ``names`` where given; ``geom``: the RGB cropped wire's layout).

    Inverse of the host-side layout (``data.loader.packed_layout``): each
    field is a byte slice of every row reinterpreted in place with
    ``Tensor.view(dtype)``.  Field offsets and the row length are multiples
    of 4, so every slice is aligned for its dtype and no bytes are copied.
    """
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed rows must be (B, row) uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    layout = packed_layout(canvas, k, fmt, geom)
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


def unpack_coefficients(values: torch.Tensor, indices: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Decompress top-K blocks of the ``index`` format to dense coefficients.

    ``values`` (..., H, W, K) int8, ``indices`` (..., H, W, K) uint8 block
    positions, ``scales`` (..., H, W) uint8.  Each value times its block's
    scale is added at its position: the JAX version's compare-and-reduce
    over the 64 positions, as a scatter-add of the same terms.  Returns
    (..., H, W, 8, 8) float32.
    """
    vals = values.to(torch.float32) * scales[..., None].to(torch.float32)
    dense = torch.zeros(vals.shape[:-1] + (64,), dtype=torch.float32, device=vals.device)
    dense.scatter_add_(-1, indices.to(torch.int64), vals)
    return dense.reshape(dense.shape[:-1] + (8, 8))


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
    """Decompress a split packed batch to dense (y, c) coefficients under any
    wire format (``data.loader.packed_layout``); the mask16 family writes
    its exact int16 DC plane into position (0, 0)."""
    unpack = unpack_coefficients if fmt == "index" else unpack_coefficients_mask
    y = unpack(f["vy"], f["iy"], f["sy"])
    c = unpack(f["vc"], f["ic"], f["sc"])
    if fmt.startswith("mask16"):
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
    buffer, its plain version on a CPU one).  An op list with an op outside
    the kernel's set (``SUPPORTED_OPS``: Equalize, Solarize, Invert,
    FreqEnhance, Rotate, ShearX, ShearY) runs the same four stages as tensor
    code on the buffer's device instead (``wire_flip_aug_range_plain``), as
    the JAX pipeline sends such a list to its XLA path; ``fused`` says which,
    chosen from the op list when the pipeline is built.  ``pipe(packed, flip, policy,
    crop=None) -> (y, cbcr, labels, weights)`` takes the draws explicitly;
    ``pipe.draw(generator, batch)`` makes them, as the JAX pipeline does from
    its key (``pipeline.py:384-389``).  Both train pipelines take and draw
    ``(flip, policy, crop)``; here ``crop`` is None, since the host cropped.
    """

    def __init__(self, target: int, ops_list, num_ops: int, magnitude: int, k: int,
                 fmt: str):
        self.target, self.k, self.fmt = target, k, fmt
        self.ops_list, self.num_ops, self.magnitude = list(ops_list), num_ops, magnitude
        self.aug = RandAugmentDCT(ops_list=self.ops_list, num_ops=num_ops,
                                  magnitude=magnitude, grid=target)
        self.fused = set(self.ops_list) <= SUPPORTED_OPS

    def draw(self, generator: torch.Generator, batch: int):
        """``(flip (B,) bool, policy, None)`` on the generator's device: each
        sample flips with probability 1/2, then ``draw_policy``."""
        flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return flip, self.aug.draw_policy(generator, batch, self.target, self.target), None

    def __call__(self, packed_buf: torch.Tensor, flip: torch.Tensor, policy, crop=None):
        if crop is not None:
            raise ValueError("the cropped wire is cropped on the host: crop must be None")
        f = split_packed_batch(packed_buf, self.target, self.k, self.fmt,
                               names=("labels", "weights"))
        stage = wire_flip_aug_range if self.fused else wire_flip_aug_range_plain
        y, c = stage(packed_buf, flip, policy, target=self.target, k=self.k, fmt=self.fmt,
                     ops_list=self.ops_list, num_ops=self.num_ops, magnitude=self.magnitude)
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


class TrainPipeline:
    """Train pipeline of the full-canvas transfers (``make_train_pipeline``,
    the JAX ``pipeline.py:280-329``): the imagenet_dct train chain
    (``datasets.py:354-361``), RandomResizedCrop(target, scale 0.05-1,
    ratio 1:1) -> HFlip -> RandAugment(num_ops, magnitude) -> ToRange(-1, 1),
    on the device.

    ``pipe(inputs, flip, policy, crop) -> (y, cbcr, labels, weights)``:
    ``inputs`` is the (B, row) uint8 tensor of ``DctPackedLoader`` rows
    (``packed``) or the dict of ``DctCanvasLoader``'s tensors (dense), which
    is unpacked and dequantized, cropped to ``target`` blocks by the boxes
    ``crop``, then flipped, augmented and rescaled in one
    ``fused_flip_aug_range`` (one launch of the kernel's dense entry on a
    CUDA tensor, its plain version on a CPU one), or, for an op list with an
    op outside the kernel's set, in tensor code (``flip_aug_range_plain``;
    ``fused`` False).  ``pipe.draw(generator,
    batch)`` makes the draws ``(flip, policy, crop)``: the boxes, then the
    flip bits and the policy, all from the one generator (JAX splits its key
    in three for them, ``pipeline.py:312``).
    """

    def __init__(self, target: int, canvas: int, ops_list, num_ops: int, magnitude: int, *,
                 packed: bool, fmt: str, k: int):
        self.target, self.canvas = target, canvas
        self.packed, self.fmt, self.k = packed, fmt, k
        self.ops_list, self.num_ops, self.magnitude = list(ops_list), num_ops, magnitude
        self.rrc = make_random_resized_crop(target, canvas)
        self.aug = RandAugmentDCT(ops_list=self.ops_list, num_ops=num_ops,
                                  magnitude=magnitude, grid=target)
        self.fused = set(self.ops_list) <= SUPPORTED_OPS

    def draw(self, generator: torch.Generator, batch: int):
        crop = self.rrc.draw(generator, batch)
        flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return flip, self.aug.draw_policy(generator, batch, self.target, self.target), crop

    def dequantized(self, inputs):
        """``(y, cbcr, labels, weights)``: the dequantized canvases."""
        return _dequantized_canvases(inputs, self.packed, self.canvas, self.k, self.fmt)

    def __call__(self, inputs, flip: torch.Tensor, policy, crop):
        y, c, labels, weights = self.dequantized(inputs)
        y, c = self.rrc.crop(y, c, crop)
        stage = fused_flip_aug_range if self.fused else flip_aug_range_plain
        y, c = stage(y, c, policy, flip, ops_list=self.ops_list, num_ops=self.num_ops,
                     magnitude=self.magnitude)
        return y, c, labels, weights


def _dequantized_canvases(inputs, packed: bool, canvas: int, k: int, fmt: str):
    """Packed rows (unpacked) or dense canvases, dequantized with their
    per-sample quant tables, with the labels and weights."""
    if packed:
        f = split_packed_batch(inputs, canvas, k, fmt)
        y, c = unpack_fields(f, fmt)
        quant, labels, weights = f["quant"], f["labels"], f["weights"]
    else:
        y, c = inputs["y"], inputs["cbcr"]
        quant, labels, weights = inputs["quant"], inputs["labels"], inputs["weights"]
    y, c = dequantize(y, c, quant)
    return y, c, labels, weights


def make_train_pipeline(cfg=None, *, target: int = 28, canvas: int = 64, auglist=None,
                        num_ops: int = 2, magnitude: int = 3, packed: bool = False,
                        packed_fmt: str = "mask", packed_k: int = 16) -> TrainPipeline:
    """The full-canvas train pipeline (:class:`TrainPipeline`); ``cfg``
    supplies the grid, the op list, the number of rounds and the
    magnitude."""
    if cfg is not None:
        target = cfg.model.dct_blocks
        auglist = list(cfg.train.auglist)
        num_ops = cfg.train.num_ops
        magnitude = cfg.train.augstr
    return TrainPipeline(target, canvas, list(auglist or []), num_ops, magnitude,
                         packed=packed, fmt=packed_fmt, k=packed_k)


def make_eval_pipeline(cfg=None, *, target: int = 28, canvas: int = 64, swin: bool = False,
                       packed: bool = False, packed_fmt: str = "mask",
                       packed_k: int = 16) -> Callable:
    """The full-canvas eval pipeline (the JAX ``pipeline.py:434-474``):
    unpack (``packed``) -> dequantize -> the ViT's ResizedCenterCrop(target
    + 4 -> target) (``datasets.py:364``) or SwinV2's whole-canvas resize to
    ``target`` (``datasets.py:381``) -> ToRange(-1, 1).  ``fn(inputs) -> (y,
    cbcr, labels, weights)``, ``inputs`` as :class:`TrainPipeline` takes
    them."""
    if cfg is not None:
        target = cfg.model.dct_blocks
        swin = cfg.model.arch == "swinv2"
    crop = make_full_resize(target, canvas) if swin else \
        make_center_crop_resize(target + 4, target, canvas)

    def pipeline(inputs):
        y, c, labels, weights = _dequantized_canvases(inputs, packed, canvas, packed_k,
                                                      packed_fmt)
        y, c = crop(y, c)
        return to_range(y), to_range(c), labels, weights

    return pipeline


# ---------------------------------------------------------------- RGB domain
def make_packed_rgb_decode(canvas: int = 64, k: int = 63, fmt: str = "mask16") -> Callable:
    """Packed coefficient rows (``DctPackedLoader``, a ``canvas``-block
    canvas) -> RGB pixels on the rows' device: unpack, dequantize, the JPEG
    tail decode (``ops.pixel_decode``).  ``fn(packed) -> (pixels (B, 3,
    8 canvas, 8 canvas) float32, labels, weights)`` (the JAX
    ``pipeline.py:139-161``)."""

    def decode(packed_buf: torch.Tensor):
        f = split_packed_batch(packed_buf, canvas, k, fmt)
        y, c = dequantize(*unpack_fields(f, fmt), f["quant"])
        return decode_rgb_pixels(y, c), f["labels"], f["weights"]

    return decode


class RgbCroppedTrainPipeline:
    """The RGB crop-before-pack train pipeline (``RgbCroppedLoader``; the
    JAX ``make_rgb_cropped_train_pipeline``, ``pipeline.py:164-219``): the
    window's K-``k`` mask16 rows -> the JPEG tail decode -> the residual
    box's bilinear resample (``geom``) -> HFlip -> RandAugment (``fill``
    128) -> [-1, 1].  ``pipe(packed, flip, policy, crop=None) -> (img (B, 3,
    size, size), labels, weights)`` takes the draws; ``pipe.draw(generator,
    batch)`` makes ``(flip, policy, None)``: the host cropped.  The stages
    are :meth:`decode`, :meth:`resample` and :meth:`augment`."""

    def __init__(self, size: int, k: int, auglist, num_ops: int, magnitude: int,
                 fill: float = 128.0):
        self.size, self.k = size, k
        self.aug = RandAugmentRGB(ops_list=list(auglist or []), num_ops=num_ops,
                                  magnitude=magnitude, image_hw=(size, size), fill=fill)

    def draw(self, generator: torch.Generator, batch: int):
        flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return flip, self.aug.draw_policy(generator, batch), None

    def decode(self, packed_buf: torch.Tensor):
        """``(pixels (B, 3, size, size), geom (B, 4), labels, weights)``."""
        return _rgb_window(packed_buf, self.size, self.k)

    def resample(self, pixels: torch.Tensor, geom: torch.Tensor) -> torch.Tensor:
        return _residual_resample(pixels, geom, self.size)

    def augment(self, img: torch.Tensor, flip, policy) -> torch.Tensor:
        return self.aug.apply(flip_images(img, flip), policy)

    def __call__(self, packed_buf: torch.Tensor, flip, policy, crop=None):
        if crop is not None:
            raise ValueError("the cropped wire is cropped on the host: crop must be None")
        pixels, geom, labels, weights = self.decode(packed_buf)
        img = self.augment(self.resample(pixels, geom), flip, policy)
        return to_unit_range(img), labels, weights


def _rgb_window(packed_buf: torch.Tensor, size: int, k: int):
    """Decode the RGB cropped wire's window: ``(pixels, geom, labels, weights)``."""
    f = split_packed_batch(packed_buf, size // 8, k, "mask16", geom=True)
    y, c = unpack_fields(f, "mask16")  # the wire carries dequantized coefficients
    return decode_rgb_pixels(y, c), f["geom"], f["labels"], f["weights"]


def _residual_resample(pixels: torch.Tensor, geom: torch.Tensor, size: int) -> torch.Tensor:
    """The residual box (sy0, sh, sx0, sw) of each row, bilinear."""
    m_h = resample_matrix(geom[:, 0], geom[:, 1], size, size)
    m_w = resample_matrix(geom[:, 2], geom[:, 3], size, size)
    return apply_separable_rgb(pixels, m_h, m_w)


def make_rgb_cropped_train_pipeline(cfg=None, *, size: int = 224, k: int = 63, auglist=None,
                                    num_ops: int = 2, magnitude: int = 10,
                                    fill: float = 128.0) -> RgbCroppedTrainPipeline:
    """:class:`RgbCroppedTrainPipeline`; ``cfg`` supplies the input size, the
    op list, the number of rounds and the magnitude."""
    if cfg is not None:
        size, auglist = cfg.model.input_size, list(cfg.train.auglist)
        num_ops, magnitude = cfg.train.num_ops, cfg.train.augstr
    return RgbCroppedTrainPipeline(size, k, auglist, num_ops, magnitude, fill)


def make_rgb_cropped_eval_pipeline(cfg=None, *, size: int = 224, k: int = 63) -> Callable:
    """The eval twin (the JAX ``pipeline.py:222-241``): the host shipped the
    Resize + CenterCrop (ViT) or whole-image (SwinV2) box's window; decode,
    the residual resample and [-1, 1] run here.  ``fn(packed) -> (img,
    labels, weights)``."""
    if cfg is not None:
        size = cfg.model.input_size

    def pipeline(packed_buf: torch.Tensor):
        pixels, geom, labels, weights = _rgb_window(packed_buf, size, k)
        return to_unit_range(_residual_resample(pixels, geom, size)), labels, weights

    return pipeline


class RgbCanvasPipeline:
    """The RGB full-canvas transfers (the JAX Trainer's RGB ``"packed"`` and
    ``"dense"``, ``loop.py:168-197``): ``inputs`` are ``DctPackedLoader``'s
    mask16 rows of a ``canvas // 8``-block canvas, decoded on the device
    (``make_packed_rgb_decode``), or the dict of ``RgbCanvasLoader``'s
    pixel canvases; then ``augment.rgb``'s train pipeline (``train``:
    RandomResizedCrop -> HFlip -> RandAugment -> [-1, 1]) or its eval one.
    Train: ``pipe(inputs, flip, policy, crop)`` and ``pipe.draw(generator,
    batch) -> (flip, policy, crop)``; eval: ``pipe(inputs)``.  Both return
    ``(img, labels, weights)``."""

    def __init__(self, cfg, *, canvas: int, packed: bool, k: int, fmt: str, train: bool):
        if packed and canvas % 16:
            raise ValueError(f"the RGB packed transfer needs a canvas that is a multiple of "
                             f"16 (got {canvas}); use transfer='dense' for other sizes")
        self.packed, self.train = packed, train
        self.decode = make_packed_rgb_decode(canvas // 8, k, fmt) if packed else None
        self.stage = (make_rgb_train_pipeline(cfg, canvas=canvas) if train
                      else make_rgb_eval_pipeline(cfg, canvas=canvas))

    def pixels(self, inputs):
        """``(pixels, labels, weights)`` of the inputs."""
        if self.packed:
            return self.decode(inputs)
        return inputs["pixels"], inputs["labels"], inputs["weights"]

    def draw(self, generator: torch.Generator, batch: int):
        return self.stage.draw(generator, batch)

    def __call__(self, inputs, *draws):
        pixels, labels, weights = self.pixels(inputs)
        return self.stage(pixels, *draws), labels, weights
