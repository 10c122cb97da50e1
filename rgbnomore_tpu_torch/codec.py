"""Host-side JPEG DCT coefficient codec (numpy interface), the port's copy.

The subset of ``rgbnomore_tpu/codec.py`` that the crop-before-pack loader
and the corpus writer need: the crop modes, ``crop_row_offsets``,
``read_crop_resize_pack_row`` and ``write_tensor``.  They wrap the port's own
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
    "crop_row_offsets",
    "read_crop_resize_pack_row",
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

CROP_RANDOM = 0  # RandomResizedCrop_DCT box distribution (train)
CROP_CENTER = 1  # ResizedCenterCrop_DCT (ViT val)
CROP_FULL = 2  # whole-image Resize_DCT (swin val)


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
