"""rgbnomore_tpu_torch — the PyTorch + CUDA port of ``rgbnomore_tpu``.

Trains and evaluates vision transformers on JPEG DCT coefficients, and on
the RGB pixels decoded from them on the card (the paper's baseline), on an
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
                 the DCT-domain photometric, block and geometry ops, the
                 fast DCT, the JPEG tail decode to pixels, the build.
- ``augment``  — the device half of the input pipelines (DCT and RGB), the
                 batched DCT and RGB RandAugment, the pixel oracles.
- ``codec``    — the host JPEG codec (C++/libjpeg extension + wrappers).
- ``data``     — index datasets, the loaders of both domains, dataset
                 staging.
- ``models``   — the ViT with every patch embedding, SwinV2, and flax's
                 dtype rules and dropout.
- ``train``    — config, mixup and loss, clip + AdamW + schedule, the
                 trainer's train step and eval, checkpoints, the epoch
                 loop ``train_and_eval``, the reference ``.pth`` importer.
- ``parallel`` — data parallelism: one process per GPU over NCCL.
- ``utils``    — the loss window, timing, the model summary, profiling and
                 FLOP counts.
- ``cli``, ``eval`` — the train and eval CLIs (``python -m``), with
                 ``train.py``'s flags.
"""

__version__ = "0.1.0"
