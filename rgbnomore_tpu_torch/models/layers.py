"""The two layers whose dtype rules the port takes from flax, for mixed
precision.

The JAX package's AMP is not an autocast: ``amp_compute_dtype``
(``rgbnomore_tpu/train/config.py:240-268``) hands one compute dtype to every
module, and flax's own promotion rules decide the rest.  Two of them differ
from PyTorch's layers:

- a flax ``Dense`` with ``dtype`` (``torch_dense``,
  ``rgbnomore_tpu/models/embeddings.py:74-84``) casts its input, kernel and
  bias to that dtype and returns it; its parameters stay float32, so their
  gradients and the AdamW moments do too.  :class:`Linear` does the same.
- a flax ``LayerNorm`` with float32 parameters computes its statistics in
  float32 and returns float32 for a bf16 or fp16 input, where
  ``nn.LayerNorm`` would return the input's dtype.  :class:`LayerNorm`
  upcasts its input first.

Both subclass the PyTorch layers, so parameter names, ``state_dict`` keys
and the ``isinstance`` tests of the init and of the weight-decay mask stay
as they were.  At float32 each is the PyTorch layer unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LayerNorm", "Linear"]


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: the input, weight and bias are
    cast to it and the output has it (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and output are float32 whatever the
    input's dtype (flax ``LayerNorm`` with float32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32))
