"""Carry the JAX package's ViT parameters into the port's ``state_dict``.

The flax tree and the torch modules share their names (``patchembed/
projection``, ``encoder_{i}/{ln1, mha/qkv, mha/projection, ln2, mlp1, mlp2}``,
``head/{ln, linear1, linear2}``), so each leaf maps to one key:
a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in), a
LayerNorm ``scale`` becomes ``weight``, a ``bias`` stays ``bias``.  The qkv
kernel keeps the JAX layout of contiguous thirds (q | k | v), which the
port's ``MultiHeadAttention`` splits the same way — not the interleaved
layout of the reference's checkpoints (``train/torch_import.py:38-46``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict"]


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
            if name == "kernel":
                if arr.ndim != 2:
                    raise NotImplementedError(
                        f"{module}: {arr.ndim}-D kernels (convolutions) are not "
                        "ported yet")
                out[f"{module}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
            elif name in ("scale", "bias"):
                key = "weight" if name == "scale" else "bias"
                out[f"{module}.{key}"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unexpected flax parameter {module}/{name}")

    walk(params, ())
    return out
