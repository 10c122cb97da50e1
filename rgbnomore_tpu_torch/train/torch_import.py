"""Import the reference's PyTorch checkpoints (``.pth``) into the port.

The port's copy of the JAX package's ``train/torch_import.py``: the same
name map from the reference's modules (``models/plainvit.py``,
``models/swinv2.py``) to a flax-shaped tree of numpy arrays, which
``convert.flax_to_state_dict`` turns into the port's ``state_dict``.  The
models load the result with ``load_state_dict(strict=True)``.

The reference splits its ViT's fused qkv output as ``(h d qkv)``
(``plainvit.py:447``): q, k and v interleaved per (head, dim) with stride
1.  The port splits into contiguous thirds, so the importer permutes the
rows (:func:`_qkv`).  SwinV2's fused qkv is already in thirds, and its
buffers (coordinate tables, attention masks) are the port's non-persistent
buffers, recomputed at construction and skipped here.

Accepts bare state dicts, the reference's epoch-checkpoint dicts
(``{'model_state_dict': ...}``) and DDP-prefixed names (``module.*``).

    from rgbnomore_tpu_torch.train.torch_import import load_torch_checkpoint

    sd = load_torch_checkpoint("vits.pth", num_heads=6, head_size=64, depth=12,
                               ver=2, use_subblock=True)
    model.load_state_dict(sd)  # a model of the same configuration
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from rgbnomore_tpu_torch.convert import flax_to_state_dict

__all__ = ["import_swin_state_dict", "import_vit_state_dict", "load_torch_checkpoint"]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}


def _layernorm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _qkv(sd: Mapping, prefix: str, num_heads: int, head_size: int) -> dict:
    """Permute the reference's (h, d, qkv)-interleaved fused QKV to (qkv, h, d)."""
    w = _np(sd[f"{prefix}.weight"])  # (3*h*d, in), rows ordered (h, d, qkv)
    b = _np(sd[f"{prefix}.bias"])
    in_dim = w.shape[1]
    w = w.reshape(num_heads, head_size, 3, in_dim).transpose(2, 0, 1, 3)
    b = b.reshape(num_heads, head_size, 3).transpose(2, 0, 1)
    return {"kernel": w.reshape(3 * num_heads * head_size, in_dim).T,
            "bias": b.reshape(-1)}


def _strip_prefixes(sd: Mapping) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def import_vit_state_dict(
    state_dict: Mapping,
    *,
    num_heads: int,
    head_size: int,
    depth: int,
    ver: int = 1,
    use_subblock: bool = True,
    pixel_space: str = "DCT",
) -> dict[str, torch.Tensor]:
    """The port's ViT ``state_dict`` from a reference ViT state dict."""
    sd = _strip_prefixes(state_dict)
    params: dict = {}

    pe: dict = {}
    if pixel_space.upper() == "RGB":
        w = _np(sd["patchembed.projection.0.weight"])  # (E, 3, P, P)
        pe["projection"] = {
            "kernel": w.transpose(2, 3, 1, 0),  # (P, P, in, E), flax's conv layout
            "bias": _np(sd["patchembed.projection.0.bias"]),
        }
    elif ver == 1:
        pe["projection"] = _linear(sd, "patchembed.projection.0")
    elif ver == 2 and use_subblock:
        pe["projection_y"] = _linear(sd, "patchembed.projection_Y.1")
        pe["projection_c"] = _linear(sd, "patchembed.projection_C.1")
        pe["linear_mix"] = _linear(sd, "patchembed.linearMix")
    elif ver == 2:
        for ours, theirs in (("linear_y", "LinearY"), ("linear_c", "LinearC")):
            i = 0
            while f"patchembed.{theirs}.{i}.weight" in sd:
                pe[f"{ours}{i}"] = _linear(sd, f"patchembed.{theirs}.{i}")
                i += 1
        pe["linear_mix"] = _linear(sd, "patchembed.LinearMix")
    elif ver == 3:
        pe["projection_y"] = _linear(sd, "patchembed.projectionY.1")
        pe["projection_c"] = _linear(sd, "patchembed.projectionC.1")
    params["patchembed"] = pe

    for i in range(depth):
        blk = f"encoder.{i}"
        params[f"encoder_{i}"] = {
            "ln1": _layernorm(sd, f"{blk}.0.fn.eb_lrnorm1"),
            "mha": {
                "qkv": _qkv(sd, f"{blk}.0.fn.eb_mha.qkv", num_heads, head_size),
                "projection": _linear(sd, f"{blk}.0.fn.eb_mha.projection"),
            },
            "ln2": _layernorm(sd, f"{blk}.1.fn.eb_lrnorm2"),
            "mlp1": _linear(sd, f"{blk}.1.fn.eb_ffb.0"),
            "mlp2": _linear(sd, f"{blk}.1.fn.eb_ffb.3"),
        }

    params["head"] = {
        "ln": _layernorm(sd, "classhead.ch_lrnorm"),
        "linear1": _linear(sd, "classhead.ch_linear1"),
        "linear2": _linear(sd, "classhead.ch_linear2"),
    }
    return flax_to_state_dict(params)


def import_swin_state_dict(
    state_dict: Mapping,
    *,
    depths=(2, 2, 6, 2),
    pixel_space: str = "DCT",
) -> dict[str, torch.Tensor]:
    """The port's SwinV2 ``state_dict`` from a reference SwinV2 state dict."""
    sd = _strip_prefixes(state_dict)
    params: dict = {}

    if pixel_space.upper() == "RGB":
        w = _np(sd["patch_embed.proj.weight"])  # (E, C, P, P)
        params["patch_embed"] = {"kernel": w.transpose(2, 3, 1, 0),
                                 "bias": _np(sd["patch_embed.proj.bias"])}
        if "patch_embed.norm.weight" in sd:
            params["patch_norm"] = _layernorm(sd, "patch_embed.norm")
    else:
        pe = {"projection": _linear(sd, "patch_embed.projection.0")}
        if "patch_embed.norm.weight" in sd:
            pe["norm"] = _layernorm(sd, "patch_embed.norm")
        params["patch_embed"] = pe

    for i, depth in enumerate(depths):
        for d in range(depth):
            blk = f"layers.{i}.blocks.{d}"
            attn = {
                "logit_scale": _np(sd[f"{blk}.attn.logit_scale"]),
                "qkv_kernel": _np(sd[f"{blk}.attn.qkv.weight"]).T,
                "cpb_mlp1": _linear(sd, f"{blk}.attn.cpb_mlp.0"),
                "cpb_mlp2": {"kernel": _np(sd[f"{blk}.attn.cpb_mlp.2.weight"]).T},
                "proj": _linear(sd, f"{blk}.attn.proj"),
            }
            if f"{blk}.attn.q_bias" in sd:
                attn["q_bias"] = _np(sd[f"{blk}.attn.q_bias"])
                attn["v_bias"] = _np(sd[f"{blk}.attn.v_bias"])
            params[f"layer{i}_block{d}"] = {
                "attn": attn,
                "norm1": _layernorm(sd, f"{blk}.norm1"),
                "norm2": _layernorm(sd, f"{blk}.norm2"),
                "mlp1": _linear(sd, f"{blk}.mlp.fc1"),
                "mlp2": _linear(sd, f"{blk}.mlp.fc2"),
            }
        if f"layers.{i}.downsample.reduction.weight" in sd:
            params[f"layer{i}_downsample"] = {
                "reduction": {"kernel": _np(sd[f"layers.{i}.downsample.reduction.weight"]).T},
                "norm": _layernorm(sd, f"layers.{i}.downsample.norm"),
            }

    params["norm"] = _layernorm(sd, "norm")
    params["head"] = _linear(sd, "head")
    if "absolute_pos_embed" in sd:
        params["absolute_pos_embed"] = _np(sd["absolute_pos_embed"])
    return flax_to_state_dict(params)


def load_torch_checkpoint(path: str, **kwargs) -> dict[str, torch.Tensor]:
    """Load a reference ViT ``.pth`` / ``.ckpt`` file (``torch.load`` with
    ``weights_only=True``) and convert it with
    :func:`import_vit_state_dict`, which takes ``kwargs``.

    Handles both the bare final ``state_dict`` (the reference's
    ``train.py:203``) and its epoch checkpoint dict
    (``pipeline_utils.py:490-516``).
    """
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return import_vit_state_dict(blob, **kwargs)
