"""The two layers whose dtype rules the port takes from flax, for mixed
precision, and flax's dropout.

The JAX package's AMP is not an autocast: ``amp_compute_dtype``
(``rgbnomore_tpu/train/config.py:240-268``) hands one compute dtype to every
module, and flax's own promotion rules decide the rest.  Two of them differ
from PyTorch's layers:

- a flax ``Dense`` with ``dtype`` (``torch_dense``,
  ``rgbnomore_tpu/models/embeddings.py:74-84``) casts its input, kernel and
  bias to that dtype and returns it; its parameters stay float32, so their
  gradients and the AdamW moments do too.  :class:`Linear` does the same,
  and :class:`Conv2d` for flax's ``Conv`` (the RGB patch embeddings).
- a flax ``LayerNorm`` with float32 parameters computes its statistics in
  float32 and returns float32 for a bf16 or fp16 input, where
  ``nn.LayerNorm`` would return the input's dtype.  :class:`LayerNorm`
  upcasts its input first.

Both subclass the PyTorch layers, so parameter names, ``state_dict`` keys
and the ``isinstance`` tests of the init and of the weight-decay mask stay
as they were.  At float32 each is the PyTorch layer unchanged, but that
:class:`Linear` computes through ``ops/linear.py:linear_tf32x3``: 3xTF32
on the tensor cores on the card, the same arithmetic in plain PyTorch on
the CPU.  In bf16 and fp16 it calls ``F.linear``, counted in
``rgbnm.linear.library``.

:class:`Dropout` is flax's ``nn.Dropout``: ``select(mask, x / keep, 0)``
with ``keep = 1 - rate`` rounded to x's dtype (flax divides by a
weak-typed Python float), which ``x * (1 / keep)`` would round differently
in bf16.  Its masks come from the forward's :class:`DropoutMasks`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rgbnomore_tpu_torch.ops.linear import linear_tf32x3
from rgbnomore_tpu_torch.utils import profiling

__all__ = ["Conv2d", "Dropout", "DropoutMasks", "LayerNorm", "Linear"]


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
        if dt == torch.float32:
            return linear_tf32x3(x.to(dt), self.weight.to(dt), bias)
        profiling.count("rgbnm.linear.library")
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (stride = kernel, no padding: a patch projection)
    computing in ``dtype`` (flax ``Conv(dtype=...)``)."""

    def __init__(self, in_channels: int, out_channels: int, patch: int, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, patch, stride=patch)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=self.stride)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and output are float32 whatever the
    input's dtype (flax ``LayerNorm`` with float32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32))


class DropoutMasks:
    """The keep masks of one forward pass's dropout sites, in the order the
    model reaches them: drawn on the device of each input from
    ``generator`` (each element kept with probability ``1 - rate``), or
    taken from ``masks``, one bool tensor of the input's shape per site
    (a test hands over flax's)."""

    def __init__(self, generator: torch.Generator | None = None, masks=None):
        if (generator is None) == (masks is None):
            raise ValueError("give DropoutMasks a generator or a list of masks, not both")
        self.generator = generator
        self._masks = None if masks is None else iter(masks)

    def apply(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """``x`` through the next site's dropout at ``rate`` (0 < rate)."""
        if rate >= 1.0:  # flax: zeros, without drawing a mask
            return torch.zeros_like(x)
        keep = 1.0 - rate
        if self._masks is None:  # drawn straight into bool: one byte an element
            mask = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
                keep, generator=self.generator)
        else:
            mask = next(self._masks).to(x.device)
        keep_x = torch.tensor(keep, dtype=x.dtype).item()  # exact in x's dtype
        return torch.where(mask, x / keep_x, 0.0)


class Dropout(nn.Module):
    """Dropout at ``rate`` in training (flax ``nn.Dropout``); the identity at
    rate 0 and in eval mode.  ``forward(x, masks)`` takes the forward's
    :class:`DropoutMasks`, which it reads only when it drops."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, masks: DropoutMasks | None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if masks is None:
            raise ValueError(f"dropout at rate {self.rate} in training needs the step's "
                             "DropoutMasks")
        return masks.apply(x, self.rate)
