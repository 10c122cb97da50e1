"""Config system: dataclass presets mirroring the reference's yacs tree.

The dataclasses, augmentation lists, ``generate_config`` and
``update_runtime`` are a copy of ``rgbnomore_tpu/train/config.py``
(reproducing ``utils/configs.py:60-178`` of the reference), and so is
``amp_compute_dtype``, which names torch dtypes.  ``build_model`` and
``example_inputs`` are the port's own and return torch modules and
tensors.  Sentinel convention for CLI overrides: ``None`` means "use preset".
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Sequence

import torch

from rgbnomore_tpu_torch.device import resolve_device

DEFAULT_SEED = 11997733

# Default DCT augmentation list (``configs.py:29``)
AUGLIST_DCT = (
    "AutoContrast,Posterize,Color,Contrast,Brightness,Sharpness,Cutout,"
    "TranslateX,TranslateY,Rotate90,AutoSaturation,Grayscale,MidfreqAug,ChromaDrop"
).split(",")
# ViT-Ti DCT list: +SolarizeAdd, -Sharpness (``configs.py:93``)
AUGLIST_DCT_VITTI = (
    "AutoContrast,Posterize,SolarizeAdd,Color,Contrast,Brightness,MidfreqAug,"
    "Cutout,TranslateX,TranslateY,Rotate90,AutoSaturation,Grayscale,ChromaDrop"
).split(",")
# RGB list (``configs.py:175``)
AUGLIST_RGB = (
    "AutoContrast,Equalize,Contrast,Brightness,Color,Sharpness,Posterize,"
    "Invert,Solarize,SolarizeAdd,TranslateX,TranslateY,Cutout,Rotate,ShearX,ShearY"
).split(",")


@dataclass
class ModelConfig:
    arch: str = "vits"
    domain: str = "DCT"  # 'DCT' or 'RGB'
    patch_size: int = 16
    version: int = 1  # embed_type: 1 grouped, 2 separate, 3 concatenate
    subblock: bool = True
    classes: int = 1000
    heads: Sequence[int] | int = 6
    head_size: int = 64
    embed_size: int = 384
    depth: Sequence[int] | int = 12
    mixup: bool = True
    amp_dtype: str = "fp16"  # reference default; on TPU 'bf16' is used
    # bias init family: "torch" = reference-parity U(+-1/sqrt(fan_in))
    # (default); "zeros" = the round-2/3 zero-bias family, selected by
    # short-horizon proxy tooling (see models/embeddings.py set_bias_family)
    bias_init: str = "torch"
    # SwinV2-only
    window_size: int = 8
    mlp_ratio: int = 4
    drop_path: float = 0.0
    qkv_bias: bool = True
    ape: bool = False
    patch_norm: bool = True
    pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0)
    # swin: XLA block-diagonal window pairing (two 64-token windows share one
    # 128-lane MXU logits tile); bit-exact vs the plain path, A/B'd in
    # SWIN_PROFILE.json before becoming a default
    paired_attention: bool = False
    # input geometry (blocks for DCT, pixels for RGB) filled by update_config
    input_size: int = 224
    dct_blocks: int = 28


@dataclass
class TrainConfig:
    epochs: int = 300
    batch_size: int = 1024  # global batch across all chips
    lr: float = 3e-3
    wd: float = 3e-4
    drop: float = 0.0
    warmup: int = 10000
    auglist: Sequence[str] = field(default_factory=lambda: list(AUGLIST_DCT))
    num_ops: int = 2
    augstr: int = 3  # ops magnitude
    augmax: int = 10  # magnitude bins - 1
    split: float = 0.01  # minival fraction
    amp: bool = False
    deterministic: bool = False
    dataset: str = "imagenet"
    batch_per_device: int = 128  # filled by update_config
    # Beta(alpha, alpha) mixup strength.  The reference constructs its mixup
    # with alpha=0.2 for BOTH domains (pipeline_utils.py:179-181) — NOT the
    # paper default 1.0.  With the sorted-lambda convention, alpha=0.2 keeps
    # lambda near 1 most steps (weak mixing); 1.0 would mix lambda~U(.5,1)
    # every step, which provably stalls short-horizon proxy runs.
    mixup_alpha: float = 0.2


@dataclass
class Config:
    seed: int = DEFAULT_SEED
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def generate_config(
    modelarch: str = "vits",
    domain: str = "dct",
    modelver: int | None = None,
    subblock: bool | None = None,
    epochs: int | None = None,
    batchsize: int | None = None,
    lr: float | None = None,
    wd: float | None = None,
    drop: float | None = None,
    warmup_steps: int | None = None,
    auglist: str | None = None,
    num_ops: int | None = None,
    ops_magnitude: int | None = None,
    augstr: int | None = None,
    seed: int | None = None,
    amp: bool | None = None,
    ampdtype: str | None = None,
    deterministic: bool | None = None,
) -> Config:
    """Build the per-architecture preset config with CLI overrides applied.

    Mirrors ``utils/configs.py:60-178``.
    """
    cfg = Config()
    cfg.model.domain = domain.upper()
    cfg.model.arch = modelarch

    if modelarch == "vitti":
        cfg.model.heads, cfg.model.embed_size, cfg.model.depth = 3, 192, 12
        cfg.model.patch_size = 16
        if cfg.model.domain == "DCT":
            cfg.train.auglist = list(AUGLIST_DCT_VITTI)
        cfg.train.wd = 1e-4
        cfg.train.amp = False
    elif modelarch == "vits":
        cfg.model.heads, cfg.model.embed_size, cfg.model.depth = 6, 384, 12
        cfg.model.patch_size = 16
        cfg.train.epochs = 90
        cfg.train.amp = False
    elif modelarch == "vitb":
        cfg.model.heads, cfg.model.embed_size, cfg.model.depth = 12, 768, 12
        cfg.model.patch_size = 16
        cfg.train.amp = True
        cfg.model.amp_dtype = "bf16"
        cfg.train.lr = 1e-3
        cfg.train.wd = 1e-4
        cfg.train.batch_size = 512
    elif modelarch == "vitl":  # untested in the reference as well
        cfg.model.heads, cfg.model.embed_size, cfg.model.depth = 12, 1024, 24
        cfg.model.patch_size = 16
        cfg.train.amp = True
        cfg.model.amp_dtype = "bf16"
    elif modelarch == "swinv2":
        cfg.model.heads = (3, 6, 12, 24)
        cfg.model.embed_size = 96
        cfg.model.depth = (2, 2, 6, 2)
        cfg.model.window_size = 8
        cfg.model.mlp_ratio = 4
        cfg.model.drop_path = 0.2
        cfg.model.qkv_bias = True
        cfg.model.ape = False
        cfg.model.patch_norm = True
        cfg.model.patch_size = 4
        cfg.train.amp = True
        # Documented divergence: the reference trains swinv2 with fp16
        # autocast + GradScaler (configs.py:18 default + train.py:153); on TPU
        # the native AMP dtype is bf16 (same exponent range as f32, no scaler
        # needed).  ``--ampdtype fp16`` still honors fp16 if explicitly asked.
        cfg.model.amp_dtype = "bf16"
        cfg.train.batch_size = 512
    else:
        raise ValueError(f"Unknown model arch: {modelarch}")

    if modelver is not None:
        cfg.model.version = modelver
    if subblock is not None:
        cfg.model.subblock = subblock
    if epochs is not None:
        cfg.train.epochs = epochs
    if lr is not None:
        cfg.train.lr = lr
    if wd is not None:
        cfg.train.wd = wd
    if drop is not None:
        cfg.train.drop = drop
    if warmup_steps is not None:
        cfg.train.warmup = warmup_steps
    if num_ops is not None:
        cfg.train.num_ops = num_ops
    if ops_magnitude is not None:
        cfg.train.augstr = ops_magnitude
    if augstr is not None:
        cfg.train.augmax = augstr
    if seed is not None:
        cfg.seed = seed
    if batchsize is not None:
        cfg.train.batch_size = batchsize
    if auglist is not None:
        cfg.train.auglist = auglist.split(",") if isinstance(auglist, str) else list(auglist)
    if amp is not None:
        cfg.train.amp = bool(amp)
    if ampdtype is not None:
        cfg.model.amp_dtype = ampdtype
    if deterministic is not None:
        cfg.train.deterministic = bool(deterministic)

    if cfg.model.domain == "RGB":
        cfg.train.lr = 1e-3 if lr is None else lr
        cfg.train.wd = 1e-4 if wd is None else wd
        if auglist is None:
            cfg.train.auglist = list(AUGLIST_RGB)
        if ops_magnitude is None:
            cfg.train.augstr = 10

    # dataset name + input geometry (reference: pipeline_utils.update_config)
    swin = modelarch == "swinv2"
    if cfg.model.domain == "DCT":
        cfg.train.dataset = "imagenet_dct_swin" if swin else "imagenet_dct"
        cfg.model.dct_blocks = 32 if swin else 28
        cfg.model.input_size = cfg.model.dct_blocks * 8
    else:
        cfg.train.dataset = "imagenet_swin" if swin else "imagenet"
        cfg.model.input_size = 256 if swin else 224
    return cfg


def update_runtime(cfg: Config, num_devices: int) -> Config:
    """Fill per-device batch (reference: BATCHPERGPU, ``pipeline_utils.py:145``).

    Deep-copies so the caller's config is never mutated (dataclasses.replace
    would share the nested TrainConfig instance).
    """
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.train.batch_per_device = max(1, cfg.train.batch_size // max(1, num_devices))
    return cfg


def amp_compute_dtype(cfg: Config) -> torch.dtype:
    """The compute dtype of mixed precision (``rgbnomore_tpu/train/config.py:
    240-268``): float32 without ``cfg.train.amp``; with it, bf16 for
    ``cfg.model.amp_dtype`` "bf16" or "bfloat16", fp16 for "fp16",
    "float16" or "half" (with a warning: fp16 trains with the reference's
    dynamic loss scaling, ``train/scaler.py``); anything else raises
    ``ValueError``."""
    if not cfg.train.amp:
        return torch.float32
    name = str(cfg.model.amp_dtype).lower()
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("fp16", "float16", "half"):
        logging.getLogger(__name__).warning(
            "ampdtype=fp16: dynamic loss scaling active (growth 1.6 / backoff "
            "0.625 / interval 600, clamp [2^-4, 2^18] — the reference's "
            "GradScaler, pipeline_utils.py:540-541); bf16 needs none")
        return torch.float16
    raise ValueError(
        f"unsupported ampdtype {cfg.model.amp_dtype!r}: use 'bf16' or 'fp16'"
    )


def configure_determinism(cfg: Config) -> None:
    """Apply ``cfg.train.deterministic`` (the JAX ``configure_determinism``,
    ``rgbnomore_tpu/train/config.py:271-291``; the reference's cuDNN and
    cuBLAS knobs, ``pipeline_utils.py:299-303``): a cuBLAS workspace that
    reduces in a fixed order (``CUBLAS_WORKSPACE_CONFIG``, read when a cuBLAS
    handle is made, so this runs before the first product on the card),
    deterministic cuDNN, and ``torch.use_deterministic_algorithms(True)``,
    under which an operation with no deterministic CUDA version raises.
    Does nothing when the flag is off."""
    if not cfg.train.deterministic:
        return
    import os

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)


def build_model(cfg: Config, device=None):
    """Instantiate the torch model for a config (reference: get_model,
    ``pipeline_utils.py:325-373``) on ``device`` (default ``cuda``), with
    every parameter drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` in the ``cfg.model.bias_init`` family.  The model computes
    in ``amp_compute_dtype(cfg)`` (its parameters stay float32)."""
    from rgbnomore_tpu_torch.models import SwinTransformerV2, ViT

    dev = resolve_device(device)
    dtype = amp_compute_dtype(cfg)
    if cfg.model.arch == "swinv2":
        model = SwinTransformerV2(
            img_size=cfg.model.input_size,
            num_classes=cfg.model.classes,
            embed_dim=cfg.model.embed_size,
            depths=tuple(cfg.model.depth),
            num_heads=tuple(cfg.model.heads),
            window_size=cfg.model.window_size,
            mlp_ratio=float(cfg.model.mlp_ratio),
            qkv_bias=cfg.model.qkv_bias,
            drop_rate=cfg.train.drop,
            drop_path_rate=cfg.model.drop_path,
            ape=cfg.model.ape,
            patch_norm=cfg.model.patch_norm,
            pretrained_window_sizes=tuple(cfg.model.pretrained_window_sizes),
            pixel_space=cfg.model.domain,
            dtype=dtype,
            patch_size=cfg.model.patch_size,
        )
    else:
        model = ViT(
            patch_size=cfg.model.patch_size,
            emb_size=cfg.model.embed_size,
            depth=int(cfg.model.depth),
            num_heads=int(cfg.model.heads),
            head_size=cfg.model.head_size,
            n_classes=cfg.model.classes,
            drop_p=cfg.train.drop,
            pixel_space=cfg.model.domain,
            ver=cfg.model.version,
            use_subblock=cfg.model.subblock,
            dtype=dtype,
        )
    gen = torch.Generator().manual_seed(cfg.seed)
    model.init_weights(gen, cfg.model.bias_init)
    return model.to(dev)


def example_inputs(cfg: Config, batch: int = 2, device=None):
    """Zero inputs with the model's expected shapes, on ``device``: (y, cbcr)
    for DCT, (pixels,) for RGB."""
    dev = resolve_device(device)
    if cfg.model.domain != "DCT":
        s = cfg.model.input_size
        return (torch.zeros((batch, 3, s, s), dtype=torch.float32, device=dev),)
    nb = cfg.model.dct_blocks
    y = torch.zeros((batch, 1, nb, nb, 8, 8), dtype=torch.float32, device=dev)
    c = torch.zeros((batch, 2, nb // 2, nb // 2, 8, 8), dtype=torch.float32, device=dev)
    return (y, c)
