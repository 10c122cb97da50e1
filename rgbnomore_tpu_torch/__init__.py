"""rgbnomore_tpu_torch — the PyTorch + CUDA port of ``rgbnomore_tpu``.

Trains and evaluates vision transformers on JPEG DCT coefficients on an
NVIDIA H100.
The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and the tests hold the two against each
other on the same inputs.  This package imports ``torch`` and never ``jax``
or anything under ``rgbnomore_tpu``; the host side (``codec``, ``native``,
``data``, ``ops.basis``) is a copy of its own.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); without a GPU they raise.  Each TPU kernel of
the reference becomes a CUDA kernel written for Hopper (``csrc/``), built with
``nvcc`` on first use and bound through ``ctypes`` (``ops/cuda_build.py``).

Subpackages
-----------
- ``ops``      — the kernels' wrappers and plain versions (attention forward
                 and backward, the fused flip + RandAugment + ToRange stage),
                 the DCT-domain photometric and block ops, the build.
- ``augment``  — the device half of the cropped DCT input pipelines and the
                 batched DCT RandAugment.
- ``codec``    — the host JPEG codec (C++/libjpeg extension + wrappers).
- ``data``     — index datasets and the crop-before-pack loader.
- ``models``   — the ViT with the grouped DCT patch embedding.
- ``train``    — config, mixup and loss, clip + AdamW + schedule, and the
                 trainer's train step and eval.
"""

__version__ = "0.1.0"
