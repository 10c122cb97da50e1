"""Host-side JPEG DCT coefficient codec (numpy interface), the port's copy.

The port's copy of ``rgbnomore_tpu/codec.py``: ``read_into_canvas`` (dense
canvases), ``read_into_packed``, ``read_into_packed_mask`` and
``read_into_packed_mask16`` (the packed wire), the crop modes,
``read_crop_resize_pack`` (into the fields' own arrays),
``crop_row_offsets`` and ``read_crop_resize_pack_row`` (into one row: the
cropped DCT wire), the RGB crop modes, ``rgb_crop_row_offsets`` and
``read_rgb_crop_pack_row`` (the cropped RGB wire), ``read_jpeg`` (a full
decode, for ``RgbCanvasLoader``), and the cold utilities
``read_coefficients``, ``write_coefficients``, ``quantize_at_quality``,
``decode_coeff`` and ``write_tensor``.  They wrap the port's own
build of ``native/dctcodec.cpp`` (a verbatim copy of the JAX package's),
loaded under the fully-qualified name ``rgbnomore_tpu_torch.native._dctcodec``
so that it never clashes with the JAX package's extension in one process.
"""

from __future__ import annotations

import importlib.util
import sys

import numpy as np

# build() is a freshness check, not just a compile: it rebuilds when the
# source is newer OR when the .so was produced on a different host CPU
# (-march=native artifacts must never be reused across machines).
from rgbnomore_tpu_torch.native.build import build as _build

__all__ = [
    "CROP_RANDOM",
    "CROP_CENTER",
    "CROP_FULL",
    "RGB_CROP_TRAIN",
    "RGB_CROP_CENTER",
    "RGB_CROP_FULL",
    "crop_row_offsets",
    "decode_coeff",
    "quantize_at_quality",
    "read_coefficients",
    "read_crop_resize_pack",
    "read_crop_resize_pack_row",
    "read_into_canvas",
    "read_into_packed",
    "read_into_packed_mask",
    "read_into_packed_mask16",
    "read_jpeg",
    "read_rgb_crop_pack_row",
    "rgb_crop_row_offsets",
    "write_coefficients",
    "write_tensor",
]

_EXT_NAME = "rgbnomore_tpu_torch.native._dctcodec"


def _load_extension():
    path = _build()
    spec = importlib.util.spec_from_file_location(_EXT_NAME, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[_EXT_NAME] = mod
    return mod


_dctcodec = _load_extension()


def _unpack_coeff_tuple(ret):
    """The extension's (ncomp, dims, quant, (yh, yw, Y), (ch, cw, CbCr) | None)
    as numpy arrays ``(dims (C, 2) int32, quant (C, 8, 8) int16, Y (1, h, w,
    8, 8) int16, CbCr (2, h2, w2, 8, 8) int16 | None)``."""
    ncomp, dims_b, quant_b, (yh, yw, y_b), ctuple = ret
    dims = np.frombuffer(dims_b, dtype=np.int32).reshape(ncomp, 2).copy()
    quant = np.frombuffer(quant_b, dtype=np.int16).reshape(3, 8, 8)[:ncomp].copy()
    y = np.frombuffer(y_b, dtype=np.int16).reshape(1, yh, yw, 8, 8).copy()
    if ctuple is None:
        return dims, quant, y, None
    ch, cw, c_b = ctuple
    return dims, quant, y, np.frombuffer(c_b, dtype=np.int16).reshape(2, ch, cw, 8, 8).copy()


def read_coefficients(path: str):
    """Quantized DCT coefficients of a JPEG (entropy decode only):
    ``(dims (C, 2) int32, quant (C, 8, 8) int16, Y (1, h, w, 8, 8) int16,
    CbCr (2, h2, w2, 8, 8) int16 | None)``."""
    return _unpack_coeff_tuple(_dctcodec.read_coefficients(str(path)))


def read_into_canvas(path: str, y_canvas: np.ndarray, c_canvas: np.ndarray,
                     quant_out: np.ndarray):
    """Decode coefficients directly into fixed-size canvases.

    ``y_canvas``: int16 C-contiguous ``(1, YH, YW, 8, 8)``; ``c_canvas``:
    int16 ``(2, CH, CW, 8, 8)``; ``quant_out``: int16 ``(3, 8, 8)``.
    Canvases are zero-filled first; the image's blocks land in the top-left
    corner.  Grayscale images leave chroma zero and chroma quant tables at 1.
    Returns ``(ncomp, yh, yw, ch, cw, img_h, img_w)``.
    """
    for a in (y_canvas, c_canvas, quant_out):
        if a.dtype != np.int16 or not a.flags.c_contiguous:
            raise ValueError("canvases and quant tables must be C-contiguous int16")
    return _dctcodec.read_into_canvas(
        str(path), y_canvas, y_canvas.shape[-4], y_canvas.shape[-3], c_canvas,
        c_canvas.shape[-4], c_canvas.shape[-3], quant_out)


def read_into_packed(path: str, k: int, vy, iy, sy, vc, ic, sc, quant_out):
    """Decode + top-K pack with one uint8 position per value (the ``index``
    wire): per 8x8 block the K largest-|v| quantized coefficients as ``int8
    round(coeff / scale)`` with ``scale uint8 = ceil(max|v| / 127)``.
    Shapes: ``vy/iy`` (1, YH, YW, K), ``sy`` (1, YH, YW); chroma likewise
    with a leading 2; ``quant_out`` (3, 8, 8) int16.  Returns ``(ncomp, yh,
    yw, ch, cw)``."""
    return _dctcodec.read_into_packed(str(path), k, vy, iy, sy, vy.shape[-3], vy.shape[-2],
                                      vc, ic, sc, vc.shape[-3], vc.shape[-2], quant_out)


def read_into_packed_mask(path: str, k: int, vy, my, sy, vc, mc, sc, quant_out):
    """Top-K pack with 8-byte occupancy bitmasks (the ``mask`` wire): bit
    ``p & 7`` of byte ``p >> 3`` set <=> position ``p`` kept, values in
    ascending position order, quantized as in :func:`read_into_packed`."""
    return _dctcodec.read_into_packed_mask(str(path), k, vy, my, sy, vy.shape[-3],
                                           vy.shape[-2], vc, mc, sc, vc.shape[-3],
                                           vc.shape[-2], quant_out)


def read_into_packed_mask16(path: str, k: int, vy, my, sy, dy, vc, mc, sc, dc, quant_out):
    """Bitmask pack with an EXACT int16 DC per block (``dy``/``dc``, (1|2, H,
    W) int16) and int8 top-K ACs scaled apart from the DC."""
    return _dctcodec.read_into_packed_mask16(str(path), k, vy, my, sy, dy, vy.shape[-3],
                                             vy.shape[-2], vc, mc, sc, dc, vc.shape[-3],
                                             vc.shape[-2], quant_out)


CROP_RANDOM = 0  # RandomResizedCrop_DCT box distribution (train)
CROP_CENTER = 1  # ResizedCenterCrop_DCT (ViT val)
CROP_FULL = 2  # whole-image Resize_DCT (swin val)


def read_crop_resize_pack(
    path: str,
    k: int,
    mode: int,
    uniforms: np.ndarray,
    pack,
    vy: np.ndarray, my: np.ndarray, sy: np.ndarray, dy: np.ndarray,
    vc: np.ndarray, mc: np.ndarray, sc: np.ndarray, dc: np.ndarray,
    quant_out: np.ndarray,
    *,
    scale: tuple[float, float] = (0.05, 1.0),
    ratio: float = 1.0,
    wide: bool = False,
    requant: bool = False,
):
    """Decode + host crop/resize to the target grid + mask16 pack of one
    image into the wire fields' own arrays (``vy``/``my``/``sy``/``dy`` for
    luma, ``vc``/``mc``/``sc``/``dc`` for chroma, ``quant_out``; e.g. the
    ``data.loader.row_views`` of one row).  :func:`read_crop_resize_pack_row`
    writes the same bytes into one consolidated row.

    ``mode`` selects the crop (``CROP_*``); ``uniforms`` float64 (12,) are
    the crop draws (mode 0 only: 10 area draws and 2 offset draws);
    ``ratio`` the center-crop ratio (mode 1); ``pack`` a
    ``data.croppack.OpPack``.  Values are dequantized (exact int16 DC, int8
    x uint8-scale ACs), so the device does not apply the quant table again,
    except on the ``mask16q`` wire (``requant``: values rounded back to
    JPEG units before top-K).  ``wide`` selects the int16-AC ``mask16w``
    wire (``vy``/``vc`` int16).  Returns ``(ncomp, yh, yw, ch, cw, bi, bj,
    bh, bw)`` with the sampled box.
    """
    return _dctcodec.read_crop_resize_pack(
        str(path), k, mode, pack.t_y, pack.t_c, pack.max_src,
        np.ascontiguousarray(uniforms, np.float64), float(scale[0]),
        float(scale[1]), float(ratio), pack.evens, pack.spec, pack.data,
        vy, my, sy, dy, vc, mc, sc, dc, quant_out, int(wide), int(requant),
    )


def crop_row_offsets(layout: dict) -> np.ndarray:
    """int64 (11,) byte offsets for :func:`read_crop_resize_pack_row`, in the
    fixed field order [vy, iy, sy, dy, vc, ic, sc, dc, quant, labels,
    weights], taken from a ``data.loader.packed_layout`` mask16 layout."""
    order = ("vy", "iy", "sy", "dy", "vc", "ic", "sc", "dc", "quant",
             "labels", "weights")
    return np.asarray([layout[f][0] for f in order], np.int64)


def read_crop_resize_pack_row(
    path: str,
    k: int,
    mode: int,
    uniforms: np.ndarray,
    pack,
    row: np.ndarray,
    offsets: np.ndarray,
    label: int,
    weight: float = 1.0,
    *,
    scale: tuple[float, float] = (0.05, 1.0),
    ratio: float = 1.0,
    wide: bool = False,
    requant: bool = False,
):
    """Decode + host crop/resize to the target grid + mask16 pack of one
    image, writing every per-sample field (including label/weight) into ONE
    consolidated uint8 row buffer in a single GIL-free call.

    ``mode`` selects the crop (``CROP_*``); ``uniforms`` float64 (12,) are
    the crop draws (mode 0 only); ``ratio`` the center-crop ratio (mode 1);
    ``pack`` a ``data.croppack.OpPack``; ``offsets`` from
    :func:`crop_row_offsets`.  ``wide`` selects the int16-AC ``mask16w``
    wire, ``requant`` the quantized-unit ``mask16q`` wire.  Returns
    ``(ncomp, yh, yw, ch, cw, bi, bj, bh, bw)`` with the sampled box.
    """
    return _dctcodec.read_crop_resize_pack_row(
        str(path), k, mode, pack.t_y, pack.t_c, pack.max_src,
        uniforms, float(scale[0]), float(scale[1]), float(ratio),
        pack.evens, pack.spec, pack.data, row, offsets, int(label),
        float(weight), int(wide), int(requant),
    )


def write_tensor(path, data: np.ndarray, quantization=None, quality: int = 100):
    """Encode CHW uint8 pixels to a JPEG file with optional custom quant table."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    c, h, w = data.shape
    if quantization is not None:
        q = np.zeros((3, 8, 8), np.int16)
        q[: np.asarray(quantization).shape[0]] = quantization
        quantization = np.ascontiguousarray(q)
    _dctcodec.write_tensor(str(path), data, c, h, w, quantization, quality)


RGB_CROP_TRAIN = 0  # torchvision RandomResizedCrop box (datasets.py:320)
RGB_CROP_CENTER = 1  # Resize(256) + CenterCrop(224) source box (datasets.py:328)
RGB_CROP_FULL = 2  # whole image (swin val Resize only, datasets.py:347)


def rgb_crop_row_offsets(layout: dict) -> np.ndarray:
    """int64 (12,) byte offsets for :func:`read_rgb_crop_pack_row`: the 11
    mask16 fields of :func:`crop_row_offsets` and the trailing ``geom``
    float4, from a ``data.loader.packed_layout(..., geom=True)`` layout."""
    order = ("vy", "iy", "sy", "dy", "vc", "ic", "sc", "dc", "quant",
             "labels", "weights", "geom")
    return np.asarray([layout[f][0] for f in order], np.int64)


def read_rgb_crop_pack_row(path: str, k: int, t: int, mode: int, uniforms: np.ndarray,
                           g2: np.ndarray, g4: np.ndarray, row: np.ndarray,
                           offsets: np.ndarray, label: int, weight: float = 1.0, *,
                           scale: tuple[float, float] = (0.05, 1.0),
                           resize_to: float = 256.0, crop: float = 224.0):
    """The RGB crop-before-pack loader's call, one GIL-free call an image:
    samples the reference's pixel-granular crop box (``RGB_CROP_*``:
    torchvision's RandomResizedCrop, Resize + CenterCrop, the whole image),
    packs the block-aligned window covering it in a fixed ``t``-block mask16
    row, spectrally pre-downsampled per axis by the smallest f in {1, 2, 4}
    that fits, and writes the residual fractional box (``geom`` float4) for
    the device's bilinear resample after the tail decode.  ``uniforms``
    float64 (22,): 10 x (area, log-aspect) and 2 placement draws;
    ``g2``/``g4``: ``data.croppack.rgb_downsample_blocks()``.  Returns
    ``(ncomp, yh, yw, wy0, wx0, wbh, wbw, fy, fx)`` (blocks)."""
    return _dctcodec.read_rgb_crop_pack_row(
        str(path), k, t, mode, np.ascontiguousarray(uniforms, np.float64),
        float(scale[0]), float(scale[1]), float(resize_to), float(crop),
        g2, g4, row, offsets, int(label), float(weight))


def write_coefficients(path, dimensions, quantization, y, cbcr=None) -> None:
    """Write raw coefficients to a JPEG file (the inverse of
    :func:`read_coefficients`)."""
    dimensions = np.ascontiguousarray(dimensions, dtype=np.int32)
    quant = np.zeros((3, 8, 8), np.int16)
    quant[: quantization.shape[0]] = quantization
    y = np.ascontiguousarray(y, dtype=np.int16)
    img_h, img_w = int(dimensions[0, 0]), int(dimensions[0, 1])
    if cbcr is None:
        _dctcodec.write_coefficients(str(path), img_h, img_w, quant, y, y.shape[1], y.shape[2],
                                     None, 0, 0)
        return
    cbcr = np.ascontiguousarray(cbcr, dtype=np.int16)
    _dctcodec.write_coefficients(str(path), img_h, img_w, quant, y, y.shape[1], y.shape[2],
                                 cbcr, cbcr.shape[1], cbcr.shape[2])


def quantize_at_quality(pixels: np.ndarray, quality: int):
    """Encode CHW uint8 pixels at ``quality`` and return their coefficients
    as :func:`read_coefficients` does: libjpeg's quantization, bit-exact (the
    reference's encode-then-reread, ``dct_manip.cpp:315-375``)."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    c, h, w = pixels.shape
    return _unpack_coeff_tuple(_dctcodec.quantize_at_quality(pixels, c, h, w, quality))


def read_jpeg(path) -> np.ndarray:
    """Fully decode a JPEG to a CHW uint8 array."""
    c, h, w, buf = _dctcodec.read_jpeg(str(path))
    return np.frombuffer(buf, dtype=np.uint8).reshape(c, h, w).copy()


def decode_coeff(dimensions, quantization, y, cbcr=None, quality: int = -1) -> np.ndarray:
    """Decode raw DCT coefficients to CHW uint8 pixels; ``quality > 0``
    takes libjpeg's table for that quality in place of ``quantization``
    (``dct_manip.cpp:485-576``)."""
    dimensions = np.ascontiguousarray(dimensions, dtype=np.int32)
    quant = np.zeros((3, 8, 8), np.int16)
    qarr = np.asarray(quantization, dtype=np.int16)
    quant[: qarr.shape[0]] = qarr
    y = np.ascontiguousarray(y, dtype=np.int16)
    img_h, img_w = int(dimensions[0, 0]), int(dimensions[0, 1])
    if cbcr is None:
        chroma = (None, 0, 0)
    else:
        cbcr = np.ascontiguousarray(cbcr, dtype=np.int16)
        chroma = (cbcr, cbcr.shape[1], cbcr.shape[2])
    c, h, w, buf = _dctcodec.decode_coeff(img_h, img_w, quant, quality, y, y.shape[1],
                                          y.shape[2], *chroma)
    return np.frombuffer(buf, dtype=np.uint8).reshape(c, h, w).copy()
