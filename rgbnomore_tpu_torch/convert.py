"""Carry the JAX package's ViT and SwinV2 parameters into the port's
``state_dict``.

The flax tree and the torch modules share their names (ViT: ``patchembed/
{projection, projection_y, projection_c, linear_y{i}, linear_c{i},
linear_mix}`` as its embedding has them, ``encoder_{i}/{ln1, mha/qkv,
mha/projection, ln2, mlp1, mlp2}``, ``head/{ln, linear1, linear2}``;
SwinV2: ``patch_embed/{projection, norm}`` (DCT) or ``patch_embed``
and ``patch_norm`` (RGB), ``layer{i}_block{d}/{attn/{qkv,
cpb_mlp1, cpb_mlp2, proj}, norm1, mlp1, mlp2, norm2}``,
``layer{i}_downsample/{reduction, norm}``, ``norm``,
``head``, ``absolute_pos_embed``), so each leaf maps to one key:

- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in); a
  Conv ``kernel`` (kh, kw, in, out), of the RGB patch embeddings
  (``patchembed/projection``, SwinV2's ``patch_embed``), a Conv2d
  ``weight`` (out, in, kh, kw);
- SwinV2's ``qkv_kernel`` (C, 3C) becomes the ``weight`` of the attention's
  ``qkv`` Linear, transposed likewise (contiguous thirds q | k | v);
- a LayerNorm ``scale`` becomes ``weight``, a ``bias`` stays ``bias``;
- SwinV2's ``logit_scale`` (H, 1, 1), ``q_bias``, ``v_bias`` and
  ``absolute_pos_embed`` (1, L, C) are parameters of the same name and
  shape.

The ViT's qkv kernel keeps the JAX layout of contiguous thirds, which the
port's ``MultiHeadAttention`` splits the same way — not the interleaved
layout of the reference's checkpoints (``train/torch_import.py:38-46``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict"]

_SAME_NAME = ("logit_scale", "q_bias", "v_bias", "absolute_pos_embed")


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a nested dict of numpy arrays (the flax ``params`` tree, e.g.
    ``jax.tree.map(np.asarray, variables["params"])``) to a ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple[str, ...]) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (name,))
                continue
            arr = np.asarray(value, dtype=np.float32)
            module = ".".join(prefix)
            if name in ("kernel", "qkv_kernel"):
                if arr.ndim not in (2, 4):
                    raise ValueError(f"{module}: a {arr.ndim}-D kernel")
                key = "qkv.weight" if name == "qkv_kernel" else "weight"
                # (in, out) -> (out, in); (kh, kw, in, out) -> (out, in, kh, kw)
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
                out[".".join(prefix + (key,))] = torch.from_numpy(np.ascontiguousarray(arr))
            elif name in ("scale", "bias"):
                key = "weight" if name == "scale" else "bias"
                out[f"{module}.{key}"] = torch.from_numpy(arr.copy())
            elif name in _SAME_NAME:
                out[".".join(prefix + (name,))] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unexpected flax parameter {module}/{name}")

    walk(params, ())
    return out
