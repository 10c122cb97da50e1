"""Resize-operator tables for the host-side crop-before-pack path.

The C++ codec's ``read_crop_resize_pack`` applies the same gcd-based spectral
resize the device pipeline uses (``ops.basis.resize_axis_operator``,
mirroring the reference's ``utils/dct_ops.py:529-580``), but on the host,
per image, right after the Huffman decode — so only the TARGET grid's blocks
ever cross the host->device link (~5x fewer bytes than shipping the full
64-block canvas).

``resize_axis_operator(s, t)`` is block-diagonal: ``R = I_g (x) G`` with
``g = gcd(s, t)`` and a dense group operator ``G`` of shape
``(t/g*8, s/g*8)``.  The C++ side exploits that structure (cost per axis is
``t*8 * s*8 * (s/g*8)`` MACs instead of dense ``t*8 * s*8 * s*8``), so this
module ships only the ``G`` blocks, one per admissible source size, plus an
int32 index the C++ can look entries up in by size.

Layout passed to C++ (see ``dctcodec.cpp:py_read_crop_resize_pack``):
    spec  int32 (max_src, 10): per Y source size ``s`` (row ``s-1``):
          [s, g_y, a_y, b_y, off_y, c_src, g_c, a_c, b_c, off_c]
          where ``a = src//g``, ``b = target//g`` and ``off`` indexes into
          ``data``;  ``c_src = ceil(s/2)`` (crop modes only reach even ``s``,
          where ceil == the reference's ``h //= 2``; the full-resize mode
          needs ceil for odd-block images).
    data  float32 flat, the concatenated G blocks (row-major (b*8, a*8)).
    evens int32, the even factors of the target ascending — the reference's
          ``even_size_choices`` (``custom_transforms.py:553-555``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from rgbnomore_tpu_torch.ops.basis import resize_axis_operator

__all__ = ["OpPack", "build_op_pack", "even_factors", "rgb_downsample_blocks"]


@functools.lru_cache(maxsize=None)
def rgb_downsample_blocks() -> tuple[np.ndarray, np.ndarray]:
    """(g2, g4): the group blocks of ``resize_axis_operator(f, 1)`` for the
    RGB crop-before-pack path's per-axis {2, 4}:1 spectral pre-downsample
    (``codec.read_rgb_crop_pack_row``).  Shapes (8, 16) and (8, 32) f32."""
    g2 = np.array(resize_axis_operator(2, 1)[:8, :16], np.float32, copy=True)
    g4 = np.array(resize_axis_operator(4, 1)[:8, :32], np.float32, copy=True)
    return g2, g4


def even_factors(target: int) -> list[int]:
    """Even factors of ``target``, ascending (``custom_transforms.py:553-555``)."""
    return sorted(f for f in range(2, target + 1) if target % f == 0 and f % 2 == 0)


@dataclass(frozen=True)
class OpPack:
    t_y: int
    t_c: int
    max_src: int
    evens: np.ndarray  # int32 (Ne,)
    spec: np.ndarray  # int32 (max_src, 10) C-contiguous
    data: np.ndarray  # float32 flat


def _group_block(src: int, dst: int) -> tuple[int, int, int, np.ndarray]:
    """(g, a, b, G) with ``resize_axis_operator(src, dst) == I_g (x) G``."""
    g = math.gcd(src, dst)
    a, b = src // g, dst // g
    r = resize_axis_operator(src, dst)
    return g, a, b, np.ascontiguousarray(r[: b * 8, : a * 8], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def build_op_pack(t_y: int, max_src: int = 64) -> OpPack:
    """Operator pack covering EVERY Y source size 1..max_src (so random crops,
    center crops, the non-square fallback and whole-image resizes all hit the
    table)."""
    t_c = math.ceil(t_y / 2)
    spec = np.zeros((max_src, 10), np.int32)
    chunks: list[np.ndarray] = []
    off = 0
    for s in range(1, max_src + 1):
        gy, ay, by, g_y = _group_block(s, t_y)
        cs = (s + 1) // 2
        gc, ac, bc, g_c = _group_block(cs, t_c)
        spec[s - 1] = [s, gy, ay, by, off, cs, gc, ac, bc, off + g_y.size]
        off += g_y.size + g_c.size
        chunks.append(g_y.ravel())
        chunks.append(g_c.ravel())
    data = np.concatenate(chunks).astype(np.float32)
    evens = np.asarray(even_factors(t_y), np.int32)
    return OpPack(t_y=t_y, t_c=t_c, max_src=max_src, evens=evens,
                  spec=np.ascontiguousarray(spec), data=data)
