"""Training and evaluation orchestration: ``rgbnomore_tpu/train/loop.py`` on
one device.

``Trainer`` owns the model (the ViT or SwinV2), the input pipelines, and
once ``create_state`` has run, the optimizer and the step count.
``train_step`` takes one uploaded ``(B, row)`` uint8 batch of the cropped
K=16 mask16 train wire through pipeline (one ``wire_flip_aug_range``) ->
mixup -> forward (in train mode: SwinV2's drop path) -> softmax
cross-entropy -> backward -> global-norm clip -> AdamW, the body of the JAX
``Trainer._train_body`` (``loop.py:246-303``).  The model computes in the
config's AMP dtype (``amp_compute_dtype``: float32, bf16 or fp16); with
fp16 the step runs the fp16 branch of that body (``loop.py:273-300``): the
loss scaled by the hand-written loss scaler (``train/scaler.py``), the
gradients unscaled, an update skipped on a non-finite gradient.
``evaluate`` uploads each K=48 eval
batch in one non-blocking copy from a reused pinned buffer and runs
pipeline (one ``wire_to_range``) -> model (in eval mode) -> weighted sums
on the device.  ``cfg.train.deterministic`` turns on deterministic
algorithms (``configure_determinism``).  ``make_loaders`` builds the cropped
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
from rgbnomore_tpu_torch.train.config import (
    Config,
    amp_compute_dtype,
    build_model,
    configure_determinism,
)
from rgbnomore_tpu_torch.train.optim import Optimizer
from rgbnomore_tpu_torch.train.scaler import (
    LossScaleState,
    all_finite,
    init_loss_scale,
    update_loss_scale,
)
from rgbnomore_tpu_torch.train.steps import (
    draw_mixup_lambda,
    eval_sums,
    merge_eval_metrics,
    mixup_batch,
    softmax_cross_entropy,
)

log = logging.getLogger(__name__)

__all__ = ["PinnedUploader", "StepDraws", "Trainer", "cropped_eval_defaults",
           "guard_eval_sums", "make_loaders"]

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


class PinnedUploader:
    """Uploads (B, row) uint8 batches to a CUDA device through a ring of
    pinned host buffers that it reuses: per batch shape, two buffers taken
    in turn.  ``put`` copies the rows into the next buffer, starts a
    non-blocking copy to a new device tensor on the current stream and
    records an event after it; before a buffer is written again, the host
    waits on that event, so a copy still in flight is never overwritten.
    The rows go into the buffer through PyTorch's copy, which spreads a
    large one over the host's threads.  The buffers are ordinary tensors even
    when the first upload runs under ``torch.inference_mode`` (as
    ``Trainer.evaluate`` does), so later uploads outside it may write them."""

    DEPTH = 2

    def __init__(self, device: torch.device):
        self.device = device
        self._rings: dict[tuple, list] = {}  # shape -> [(pinned, event)] * DEPTH
        self._turn: dict[tuple, int] = {}

    def put(self, rows: np.ndarray) -> torch.Tensor:
        if rows.dtype != np.uint8 or rows.ndim != 2:
            raise ValueError(f"rows must be (B, row) uint8, got {rows.shape} {rows.dtype}")
        key = rows.shape
        if key not in self._rings:
            with torch.inference_mode(False):
                self._rings[key] = [(torch.empty(key, dtype=torch.uint8, pin_memory=True),
                                     torch.cuda.Event()) for _ in range(self.DEPTH)]
            self._turn[key] = 0
        turn = self._turn[key]
        self._turn[key] = (turn + 1) % self.DEPTH
        pinned, copied = self._rings[key][turn]
        copied.synchronize()  # the last copy out of this buffer (none yet: returns at once)
        pinned.copy_(torch.from_numpy(rows))
        out = torch.empty(key, dtype=torch.uint8, device=self.device)
        out.copy_(pinned, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))
        return out


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

    The model computes in ``compute_dtype`` (``amp_compute_dtype``); with
    fp16, ``create_state`` also makes the loss scaler's state
    (``loss_scale``), which bf16 and float32 do without.
    """

    def __init__(self, cfg: Config, device=None):
        self.device = resolve_device(device)
        if cfg.model.domain != "DCT":
            raise NotImplementedError(
                "the RGB domain is still to be ported (ROADMAP.md, port queue: RGB)")
        self.cfg = cfg
        configure_determinism(cfg)  # before the model's first cuBLAS handle
        self.compute_dtype = amp_compute_dtype(cfg)
        self.model = build_model(cfg, device=self.device)
        self.packed_k_eval, self.eval_fmt = cropped_eval_defaults(cfg.model.domain)
        self.eval_pipe = make_cropped_eval_pipeline(
            cfg, k=self.packed_k_eval, fmt=self.eval_fmt)
        self.train_pipe = make_cropped_train_pipeline(cfg, k=TRAIN_K, fmt=TRAIN_FMT)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)
        self.optimizer: Optimizer | None = None
        self.loss_scale: LossScaleState | None = None
        self._uploader: PinnedUploader | None = None

    def put_batch(self, batch: dict) -> dict:
        """Upload the consolidated (B, row) uint8 buffer (labels and weights
        ride inside the row): on the GPU one non-blocking copy through the
        Trainer's ring of reused pinned buffers (:class:`PinnedUploader`);
        on the CPU the rows themselves, uncopied."""
        if self.device.type != "cuda":
            return {"packed": torch.from_numpy(batch["packed"])}
        if self._uploader is None:
            self._uploader = PinnedUploader(self.device)
        return {"packed": self._uploader.put(batch["packed"])}

    # ------------------------------------------------------------------ train
    def create_state(self, steps_per_epoch: int) -> Optimizer:
        """Build the optimizer (clip + AdamW + warmup-cosine schedule over
        ``steps_per_epoch * cfg.train.epochs`` steps) and zero the step
        count; with fp16, start the loss scaler at 2**15."""
        if self.cfg.train.drop > 0:
            raise NotImplementedError(
                "dropout is still to be ported (ROADMAP.md, port queue): the JAX ViT drops "
                "after the attention projection, after GELU and after mlp2, and never "
                "drops attention probabilities")
        t = self.cfg.train
        self.optimizer = Optimizer(self.model, t.lr, t.wd, t.warmup,
                                   steps_per_epoch * t.epochs)
        if self.compute_dtype == torch.float16:
            self.loss_scale = init_loss_scale(device=self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("model %s/%s: %.2fM params on %s in %s, batch %d, %d steps/epoch",
                 self.cfg.model.arch, self.cfg.model.domain, n_params / 1e6, self.device,
                 self.compute_dtype, t.batch_size, steps_per_epoch)
        return self.optimizer

    @property
    def step(self) -> int:
        """Steps taken since ``create_state``, skipped ones included."""
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
        returns the loss as a 0-d tensor on the device.  With the loss
        scaler's state (fp16), the backward runs on the loss times the scale
        and the gradients are divided by it; the loss returned is the
        scaled loss divided by the scale, as the JAX step reports it."""
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
        if self.loss_scale is None:
            loss.backward()
            return loss.detach()
        scale = self.loss_scale.scale
        scaled = loss * scale
        scaled.backward()
        torch._foreach_div_([p.grad for p in self.model.parameters()], scale)
        return (scaled / scale).detach()

    def train_step(self, packed: torch.Tensor, draws: StepDraws | None = None) -> torch.Tensor:
        """One optimizer step on an uploaded (B, row) batch; returns the
        loss as a 0-d tensor on the device.  ``draws`` replaces the step's
        own draws (the tests hand over JAX's).  No host sync, but with the
        loss scaler (fp16): there the host reads whether every gradient is
        finite, skips the update if not (``Optimizer.step``), and the scale
        backs off or grows on the device (``train/scaler.py``)."""
        if self.optimizer is None:
            raise RuntimeError("call create_state before train_step")
        if draws is None:
            draws = self.draw(packed.shape[0])
        loss = self.compute_grads(packed, draws)
        if self.loss_scale is None:
            self.optimizer.step()
            return loss
        finite = all_finite(p.grad for p in self.model.parameters())
        self.optimizer.step(finite)
        self.loss_scale = update_loss_scale(self.loss_scale, finite)
        return loss

    # ------------------------------------------------------------------ eval
    def eval_step(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        """Pipeline -> model (in eval mode, in the compute dtype, float32
        logits) -> weighted sums for one uploaded batch."""
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
