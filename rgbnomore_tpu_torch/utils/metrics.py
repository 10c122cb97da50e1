"""Small host-side metric helpers: the port's copy of
``rgbnomore_tpu/utils/metrics.py``."""

from __future__ import annotations

from collections import deque

__all__ = ["LocalWindow"]


class LocalWindow:
    """Windowed running mean over the last ``maxsize`` values.

    Equivalent of the reference's 100-iteration loss window
    (``utils/pipeline_utils.py:21-50``).
    """

    def __init__(self, maxsize: int = 100):
        self._buf: deque[float] = deque(maxlen=maxsize)

    def put(self, value: float, returnval: bool = False):
        self._buf.append(float(value))
        if returnval:
            return self.mean()
        return None

    def mean(self) -> float:
        if not self._buf:
            return 0.0
        return sum(self._buf) / len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)
