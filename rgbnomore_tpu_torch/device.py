"""Device resolution for the port's entry points.

The port runs on the GPU.  ``device=None`` means ``cuda``; the CPU is used
only when a caller asks for it by name, as the tests do.  There is no silent
fall back to the CPU: a missing GPU is an error the caller sees.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the ``torch.device`` to run on; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for ``cuda`` when no GPU is visible, and
    ``ValueError`` for device types the port does not run on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on an NVIDIA GPU. "
                "Pass device='cpu' to run on the CPU instead."
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
