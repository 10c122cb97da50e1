"""Training and evaluation orchestration: ``rgbnomore_tpu/train/loop.py`` on
one device.

``Trainer`` owns the model (the ViT or SwinV2), the input pipelines, and
once ``create_state`` has run, the optimizer and the step count.
``train_step`` takes one uploaded ``(B, row)`` uint8 batch of the cropped
K=16 mask16 train wire through pipeline (``fused_flip_aug_range``) -> mixup
-> forward (in train mode: SwinV2's drop path) -> softmax cross-entropy ->
backward -> global-norm clip -> AdamW, the body of the JAX
``Trainer._train_body`` (``loop.py:246-303``) without its fp16 loss-scaling
branch (ROADMAP.md, port queue: AMP).  ``evaluate`` uploads each K=48 eval
batch in one pinned, non-blocking copy and runs pipeline -> model (in eval
mode) -> weighted sums on the device.  ``make_loaders`` builds the cropped
DCT loaders: the ViT's eval crop is the center crop, SwinV2's the
whole-image resize.  Checkpoints, ``train_and_eval`` and multi-GPU data parallelism
come with later slices (ROADMAP.md, port queue).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.pipeline import (
    make_cropped_eval_pipeline,
    make_cropped_train_pipeline,
)
from rgbnomore_tpu_torch.data.index import load_index, split_train_minival
from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.train.config import Config, build_model
from rgbnomore_tpu_torch.train.optim import Optimizer
from rgbnomore_tpu_torch.train.steps import (
    draw_mixup_lambda,
    eval_sums,
    merge_eval_metrics,
    mixup_batch,
    softmax_cross_entropy,
)

log = logging.getLogger(__name__)

__all__ = ["StepDraws", "Trainer", "cropped_eval_defaults", "guard_eval_sums",
           "make_loaders"]

TRAIN_K, TRAIN_FMT = 16, "mask16"  # the train side of the crop-before-pack wire


def cropped_eval_defaults(domain: str) -> tuple[int, str]:
    """(K, fmt) of the EVAL side of the crop-before-pack wire, shared by
    Trainer and make_loaders (the two ends of the wire must agree).

    The JAX package's K-sweep against the dense full-spectrum path
    (KSWEEP.json) measured top-1 agreement 81.5% at the train default K=16
    and 100.0% with zero logit drift at K=48, so eval ships K=48.
    """
    return (48, "mask16") if domain == "DCT" else (63, "mask16")


@dataclasses.dataclass
class StepDraws:
    """The random decisions of one train step: the flip bits (B,), the
    RandAugment policy (``RandAugmentDCT.draw_policy``), the mixup lambda
    and, for SwinV2, the drop-path keep masks (blocks, 2, B) bool (None for
    the ViT)."""

    flip: torch.Tensor
    policy: tuple
    lam: float
    drop_keep: torch.Tensor | None = None


class Trainer:
    """Owns the model, the pipelines and the optimizer for one config on one
    device.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU.  The
    model's parameters are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed``; ``model.load_state_dict`` replaces them.  The input is the
    cropped DCT wire (the JAX Trainer's ``transfer="cropped"``): K=16
    mask16 rows for training, ``cropped_eval_defaults`` for eval.  The
    step's random draws come from a ``torch.Generator`` (flip, policy, the
    drop-path keep masks) and a numpy generator (the mixup lambda), both
    seeded from ``cfg.seed``.
    """

    def __init__(self, cfg: Config, device=None):
        self.device = resolve_device(device)
        if cfg.model.domain != "DCT":
            raise NotImplementedError(
                "the RGB domain is still to be ported (ROADMAP.md, port queue: RGB)")
        self.cfg = cfg
        self.model = build_model(cfg, device=self.device)
        self.packed_k_eval, self.eval_fmt = cropped_eval_defaults(cfg.model.domain)
        self.eval_pipe = make_cropped_eval_pipeline(
            cfg, k=self.packed_k_eval, fmt=self.eval_fmt)
        self.train_pipe = make_cropped_train_pipeline(cfg, k=TRAIN_K, fmt=TRAIN_FMT)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)
        self.optimizer: Optimizer | None = None

    def put_batch(self, batch: dict) -> dict:
        """Upload the consolidated (B, row) uint8 buffer: one copy, from
        pinned memory and non-blocking on the GPU (labels and weights ride
        inside the row)."""
        buf = torch.from_numpy(batch["packed"])
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        return {"packed": buf}

    # ------------------------------------------------------------------ train
    def create_state(self, steps_per_epoch: int) -> Optimizer:
        """Build the optimizer (clip + AdamW + warmup-cosine schedule over
        ``steps_per_epoch * cfg.train.epochs`` steps) and zero the step
        count."""
        if self.cfg.train.drop > 0:
            raise NotImplementedError(
                "dropout is still to be ported: the JAX ViT then leaves the attention "
                "kernel for its einsum-with-dropout path (ROADMAP.md, port queue)")
        t = self.cfg.train
        self.optimizer = Optimizer(self.model, t.lr, t.wd, t.warmup,
                                   steps_per_epoch * t.epochs)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("model %s/%s: %.2fM params on %s, batch %d, %d steps/epoch",
                 self.cfg.model.arch, self.cfg.model.domain, n_params / 1e6, self.device,
                 t.batch_size, steps_per_epoch)
        return self.optimizer

    @property
    def step(self) -> int:
        """Updates taken since ``create_state``."""
        return self.optimizer.count if self.optimizer is not None else 0

    def draw(self, batch: int) -> StepDraws:
        """The next step's draws from the Trainer's generators.  SwinV2's
        block ``i`` keeps each sample's branch with probability ``1 -
        drop_path_rates[i]`` (always, at rate 0)."""
        flip, policy = self.train_pipe.draw(self.generator, batch)
        keep = None
        rates = getattr(self.model, "drop_path_rates", None)
        if rates is not None:
            u = torch.rand((len(rates), 2, batch), generator=self.generator)
            keep = u >= torch.tensor(rates, dtype=u.dtype)[:, None, None]
        return StepDraws(flip, policy, draw_mixup_lambda(self.rng, self.cfg.train.mixup_alpha),
                         keep)

    def compute_grads(self, packed: torch.Tensor, draws: StepDraws) -> torch.Tensor:
        """Pipeline -> mixup -> forward -> loss -> backward on an uploaded
        (B, row) batch: leaves each parameter's gradient in ``.grad`` and
        returns the loss as a 0-d tensor on the device."""
        y, c, labels, _ = self.train_pipe(packed, draws.flip, draws.policy)
        num_classes = self.cfg.model.classes
        if self.cfg.model.mixup:
            (y, c), targets = mixup_batch((y, c), labels, num_classes, draws.lam)
        else:
            targets = torch.nn.functional.one_hot(
                labels.to(torch.int64), num_classes).to(torch.float32)
        self.model.train()
        extra = {} if draws.drop_keep is None else {
            "drop_keep": draws.drop_keep.to(self.device, non_blocking=True)}
        loss = softmax_cross_entropy(self.model(y, c, **extra), targets)
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    def train_step(self, packed: torch.Tensor, draws: StepDraws | None = None) -> torch.Tensor:
        """One optimizer step on an uploaded (B, row) batch; returns the
        loss as a 0-d tensor on the device (no host sync).  ``draws``
        replaces the step's own draws (the tests hand over JAX's)."""
        if self.optimizer is None:
            raise RuntimeError("call create_state before train_step")
        if draws is None:
            draws = self.draw(packed.shape[0])
        loss = self.compute_grads(packed, draws)
        self.optimizer.step()
        return loss

    # ------------------------------------------------------------------ eval
    def eval_step(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        """Pipeline -> model (in eval mode) -> weighted sums for one
        uploaded batch."""
        self.model.eval()
        y, c, labels, weights = self.eval_pipe(packed)
        return eval_sums(self.model(y, c), labels, weights)

    @torch.inference_mode()
    def evaluate(self, loader) -> dict:
        """Accuracy, mean loss and weighted count over every batch of
        ``loader`` (an iterable of ``{"packed": uint8 (B, row)}`` dicts).
        The per-batch sums stay on the device until the merge."""
        sums = [self.eval_step(self.put_batch(batch)["packed"]) for batch in loader]
        return guard_eval_sums(sums)


def guard_eval_sums(sums: list) -> dict:
    """Merge per-batch eval sums, failing loudly on a silently-empty eval.

    A silently-empty eval (all-zero weights) would report accuracy 0.0 and
    masquerade as a model failure.  A 0-BATCH loader is a legitimately empty
    split at tiny corpus scale (split=1% of a handful of files) — warn and
    report zeros; real batches whose weights ALL unpacked to zero is a wiring
    bug — raise.
    """
    out = merge_eval_metrics(sums)
    raw_count = sum(float(s["count"]) for s in sums)
    if sums and raw_count <= 0:
        raise RuntimeError(
            f"evaluation saw no weighted examples across {len(sums)} "
            "batches; check the split/loader wiring"
        )
    if not sums:
        log.warning("evaluate: empty loader (0 batches) — reporting zeros")
    return out


def make_loaders(cfg: Config, index_train: str, index_val: str, *, num_threads: int = 4):
    """Build the train / minival / trainval / test loaders of the cropped DCT
    transfer (``datasets.py:445-582``; the JAX ``make_loaders`` :453-470):
    batches of ``cfg.train.batch_size``; train: the random-resized-crop
    boxes, the K=16 mask16 wire, shuffled, the last partial batch dropped;
    eval: to ``cfg.model.dct_blocks`` blocks by the deterministic center
    crop (ViT, ``datasets.py:364``) or the whole-image resize (SwinV2,
    ``datasets.py:381``) on the ``cropped_eval_defaults`` wire, in order,
    padded."""
    # imported here: the loader's codec needs libjpeg, the rest of this
    # module does not
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader

    if cfg.model.domain != "DCT":
        raise NotImplementedError(
            "only the cropped DCT loaders are ported so far (ROADMAP.md, port queue)")
    train_all = load_index(index_train)
    test_ds = load_index(index_val)
    train_ds, minival_ds, trainval_ds = split_train_minival(
        train_all, split=cfg.train.split, seed=cfg.seed
    )
    k_eval, fmt_eval = cropped_eval_defaults("DCT")
    eval_mode = "full" if cfg.model.arch == "swinv2" else "center"

    def mk(ds, train: bool):
        return DctCroppedLoader(
            ds, cfg.train.batch_size, target=cfg.model.dct_blocks,
            k=TRAIN_K if train else k_eval, fmt=TRAIN_FMT if train else fmt_eval,
            mode="train" if train else eval_mode, shuffle=train, drop_last=train,
            seed=cfg.seed, num_threads=num_threads,
        )

    return {"train": mk(train_ds, True), "minival": mk(minival_ds, False),
            "trainval": mk(trainval_ds, False), "test": mk(test_ds, False)}
