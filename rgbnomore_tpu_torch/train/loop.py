"""Training and evaluation orchestration: ``rgbnomore_tpu/train/loop.py``.

``Trainer`` owns the model (the ViT or SwinV2), the input pipelines, and
once ``create_state`` has run, the optimizer and the step count.  Its
``transfer`` is one of the JAX Trainer's three host-to-device formats:
``"cropped"`` (the port's default, as ``train.py``'s), ``"packed"`` (the
JAX Trainer's class default) or ``"dense"``.  ``train_step`` takes one
uploaded batch (``upload``): for the cropped transfer the ``(B, row)``
uint8 rows of the train wire (K=16 mask16 unless the caller picks another K
or format) through pipeline (one ``wire_flip_aug_range``); for the packed
and dense transfers the full-canvas rows or canvases through unpack,
dequantize and a random resized crop on the device, then one
``fused_flip_aug_range`` (the kernel's dense entry) -> mixup -> forward (in
train mode: dropout and SwinV2's drop path) -> softmax cross-entropy ->
backward -> global-norm clip -> AdamW, the body of the JAX
``Trainer._train_body`` (``loop.py:246-303``).  The model computes in the
config's AMP dtype (``amp_compute_dtype``: float32, bf16 or fp16); with
fp16 the step runs the fp16 branch of that body (``loop.py:273-300``): the
loss scaled by the hand-written loss scaler (``train/scaler.py``), the
gradients unscaled, an update skipped on a non-finite gradient.
``evaluate`` uploads each eval batch (the rows in one non-blocking copy
from a reused pinned buffer) and runs pipeline (cropped: one
``wire_to_range``) -> model (in eval mode) -> weighted sums on the device.
An op list with a DCT op outside the kernel's set runs the train stage as
tensor code (``CroppedTrainPipeline.fused``).

The RGB domain (``cfg.model.domain == "RGB"``, the paper's baseline) takes
the same three transfers: ``"cropped"`` the K=63 mask16 rows of
``RgbCroppedLoader`` (the crop box's window), decoded to pixels on the
device, resampled by the residual box, flipped and augmented by
``RandAugmentRGB``; ``"packed"`` the K=63 mask16 rows of the whole image
(``DctPackedLoader`` on a 64-block canvas) decoded to a 512-pixel canvas;
``"dense"`` ``RgbCanvasLoader``'s pixel canvases; the last two then
RandomResizedCrop on the device.  The model takes the one (B, 3, S, S)
input; mixup mixes the images; eval sums as for DCT.  The attention kernels
are the DCT models' (#1 and #2 for the ViT, #3 and #4 for SwinV2), and the
input stage launches none.
``cfg.train.deterministic`` turns on deterministic algorithms
(``configure_determinism``).  ``make_loaders`` builds the transfer's DCT
loaders: the ViT's eval crop is the center crop, SwinV2's the whole-image
resize.

Data parallelism (``parallel/``): in a process group of N ranks each
process holds the model on its own GPU and takes its slice of every global
batch; the Trainer averages the gradients over the ranks after backward
(before the fp16 unscale, the finite check and the clip), draws the whole
global batch's random decisions from the shared-seed generators and keeps
its rows, rolls mixup's pairs across the ranks, and adds the eval sums up,
so that N processes on one global batch compute what one process computes
on it.  Dropout's masks are drawn per rank.

``train_and_eval`` is the epoch loop users run (``loop.py:511-663``): per
step the loss stays on the device until the logging cadence; per epoch the
minival and trainval evals, TensorBoard scalars and a checkpoint
(``train/checkpoint.py``); the final weights as a bare ``state_dict``; or,
eval-only, test, minival and trainval on saved weights.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.pipeline import (
    RgbCanvasPipeline,
    make_cropped_eval_pipeline,
    make_cropped_train_pipeline,
    make_eval_pipeline,
    make_rgb_cropped_eval_pipeline,
    make_rgb_cropped_train_pipeline,
    make_train_pipeline,
)
from rgbnomore_tpu_torch.data.index import load_index, split_train_minival
from rgbnomore_tpu_torch import parallel
from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.models.layers import DropoutMasks
from rgbnomore_tpu_torch.train import checkpoint as ckpt
from rgbnomore_tpu_torch.train.config import (
    Config,
    amp_compute_dtype,
    build_model,
    configure_determinism,
    update_runtime,
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
from rgbnomore_tpu_torch.utils.metrics import LocalWindow

log = logging.getLogger(__name__)

__all__ = ["PinnedUploader", "StepDraws", "SummaryWriter", "TRANSFERS", "Trainer",
           "check_cropped_only", "cropped_eval_defaults", "guard_eval_sums", "load_params",
           "make_loaders", "packed_defaults", "save_params", "tensorboard_dir", "train_and_eval"]

# the train side of the crop-before-pack wire (the JAX Trainer's defaults
# for transfer="cropped", loop.py:121-123, 154)
TRAIN_K, TRAIN_FMT = 16, "mask16"
# the host -> device formats (the JAX Trainer's ``transfer``)
TRANSFERS = ("cropped", "packed", "dense")


class SummaryWriter:
    """TensorBoard writer with a no-op fallback when tensorboard is absent
    (``rgbnomore_tpu/train/loop.py:38-58``)."""

    def __init__(self, logdir: str | Path | None):
        self._writer = None
        if logdir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            log.warning("tensorboard unavailable; metrics will only be logged")
            return
        self._writer = TBWriter(str(logdir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def tensorboard_dir(savepath: str, cfg: Config) -> Path:
    """Writer dir derived from savepath + lr/wd/drop (``pipeline_utils.py:411-425``)."""
    stem = Path(savepath).stem
    name = f"{stem}_lr{cfg.train.lr}_wd{cfg.train.wd}_drop{cfg.train.drop}"
    return Path(savepath).resolve().parent / "tb_logs" / name


def check_cropped_only(transfer: str, domain: str = "DCT", **given) -> None:
    """Refuse the DCT cropped wire's own settings (``packed_k_eval``,
    ``eval_fmt``, ``train_fmt``) for the full-canvas transfers and for the
    RGB domain, which ship one wire both ways and would ignore them."""
    unused = [name for name, value in given.items() if value is not None]
    if unused and (transfer != "cropped" or domain != "DCT"):
        raise ValueError(f"{', '.join(unused)}: only transfer='cropped' takes them, and "
                         f"only in the DCT domain, not {domain} {transfer!r}")


def packed_defaults(domain: str) -> tuple[str, int]:
    """(fmt, K) of the full-canvas packed wire (``rgbnomore_tpu/train/
    loop.py:68-77``), shared by Trainer and make_loaders: DCT models ship
    the top-16 ``mask`` spectrum; the RGB domain ``mask16`` at the full AC
    spectrum (K=63), which it also ships on its cropped wire, so that the
    pixels decoded on the device stay within the IDCT's rounding of a host
    libjpeg decode."""
    return ("mask", 16) if domain == "DCT" else ("mask16", 63)


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
    RandAugment policy (``RandAugmentDCT.draw_policy``, or
    ``RandAugmentRGB.draw_policy`` in the RGB domain), the mixup lambda,
    for SwinV2 the drop-path keep masks (blocks, 2, B) bool (None for the
    ViT), at ``cfg.train.drop > 0`` the forward's dropout masks and, for the
    packed and dense transfers, the random resized crop's boxes
    ``(size_idx, i, j)`` (``RandomResizedCrop.draw``)."""

    flip: torch.Tensor
    policy: tuple
    lam: float
    drop_keep: torch.Tensor | None = None
    dropout: DropoutMasks | None = None
    crop: tuple | None = None


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
    JAX Trainer's ``transfer``, with its defaults: ``"cropped"`` (the
    default here) takes for training ``packed_k`` ACs a block (default 16)
    in ``train_fmt`` (default mask16), for eval ``packed_k_eval`` in
    ``eval_fmt`` (defaults ``cropped_eval_defaults``); ``"packed"`` takes
    ``DctPackedLoader`` rows on a ``canvas``-block canvas in the format of
    ``packed_defaults`` (mask), ``packed_k`` ACs a block (default 16), for
    both; ``"dense"`` the int16 canvases of ``DctCanvasLoader``.  The two
    full-canvas transfers refuse ``packed_k_eval``, ``eval_fmt`` and
    ``train_fmt`` (``check_cropped_only``) and leave them None.  The RGB
    domain refuses them on every transfer: its wires are mask16 at
    ``packed_k`` (default 63) both ways; its full-canvas transfers use a
    512-pixel canvas (``canvas`` 64 blocks; another ``canvas`` is taken in
    pixels).  The step's
    random draws come from a ``torch.Generator`` (crop boxes, flip, policy,
    the drop-path keep masks) and a numpy generator (the mixup lambda), both
    seeded from ``cfg.seed``, and dropout's from a generator on the device
    (``dropout_masks``).

    In a process group (``parallel.init_distributed``) the Trainer is one
    rank of a data-parallel run: ``cfg.train.batch_size`` is the global
    batch and ``cfg.train.batch_per_device`` each rank's slice
    (``update_runtime``).

    The model computes in ``compute_dtype`` (``amp_compute_dtype``); with
    fp16, ``create_state`` also makes the loss scaler's state
    (``loss_scale``), which bf16 and float32 do without.
    """

    def __init__(self, cfg: Config, device=None, *, transfer: str = "cropped",
                 canvas: int = 64, packed_k: int | None = None,
                 packed_k_eval: int | None = None, eval_fmt: str | None = None,
                 train_fmt: str | None = None):
        self.device = resolve_device(device)
        if transfer not in TRANSFERS:
            raise ValueError(f"transfer must be one of {TRANSFERS}, got {transfer!r}")
        self.transfer, self.canvas = transfer, canvas
        self.distributed = parallel.is_initialized()
        self.rank, self.world = parallel.rank(), parallel.world_size()
        self.cfg = update_runtime(cfg, self.world)
        configure_determinism(cfg)  # before the model's first cuBLAS handle
        self.compute_dtype = amp_compute_dtype(cfg)
        self.model = build_model(cfg, device=self.device)
        self.domain = cfg.model.domain
        ek, ef = cropped_eval_defaults(self.domain)
        self.packed_fmt, d_k = packed_defaults(self.domain)
        check_cropped_only(transfer, self.domain, packed_k_eval=packed_k_eval,
                           eval_fmt=eval_fmt, train_fmt=train_fmt)
        if self.domain == "RGB":
            # one mask16 wire at K=63 both ways (loop.py:117-139, 168-197)
            self.packed_k = packed_k or d_k
            self.packed_k_eval = self.eval_fmt = self.train_fmt = None
            if transfer == "cropped":
                self.train_pipe = make_rgb_cropped_train_pipeline(cfg, k=self.packed_k)
                self.eval_pipe = make_rgb_cropped_eval_pipeline(cfg, k=self.packed_k)
            else:
                wire = dict(canvas=rgb_canvas(canvas), packed=transfer == "packed",
                            k=self.packed_k, fmt=self.packed_fmt)
                self.train_pipe = RgbCanvasPipeline(cfg, train=True, **wire)
                self.eval_pipe = RgbCanvasPipeline(cfg, train=False, **wire)
        elif transfer == "cropped":
            self.packed_k, self.train_fmt = packed_k or TRAIN_K, train_fmt or TRAIN_FMT
            self.packed_k_eval, self.eval_fmt = packed_k_eval or ek, eval_fmt or ef
            self.eval_pipe = make_cropped_eval_pipeline(
                cfg, k=self.packed_k_eval, fmt=self.eval_fmt)
            self.train_pipe = make_cropped_train_pipeline(cfg, k=self.packed_k,
                                                          fmt=self.train_fmt)
        else:
            # one wire both ways (loop.py:117-126): the full canvas at
            # packed_k; the cropped wire's own settings stay unset
            self.packed_k = packed_k or d_k
            self.packed_k_eval = self.eval_fmt = self.train_fmt = None
            packed = transfer == "packed"
            wire = dict(canvas=canvas, packed=packed, packed_fmt=self.packed_fmt,
                        packed_k=self.packed_k)
            self.train_pipe = make_train_pipeline(cfg, **wire)
            self.eval_pipe = make_eval_pipeline(cfg, **wire)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)
        self._dropout_generator = (torch.Generator(device=self.device)
                                   if cfg.train.drop > 0 else None)
        self.optimizer: Optimizer | None = None
        self.loss_scale: LossScaleState | None = None
        self._uploader: PinnedUploader | None = None

    def global_batch(self) -> int:
        """The batch of one step over every rank."""
        return self.cfg.train.batch_per_device * self.world

    def put_batch(self, batch: dict) -> dict:
        """Upload a loader's batch.  The cropped and packed transfers upload
        the consolidated (B, row) uint8 buffer (labels and weights ride
        inside the row) as ``{"packed": ...}``: on the GPU one non-blocking
        copy through the Trainer's ring of reused pinned buffers
        (:class:`PinnedUploader`); on the CPU the rows themselves, uncopied.
        The dense transfer uploads each array of the batch."""
        if self.transfer == "dense":
            return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                    for k, v in batch.items()}
        if self.device.type != "cuda":
            return {"packed": torch.from_numpy(batch["packed"])}
        if self._uploader is None:
            self._uploader = PinnedUploader(self.device)
        return {"packed": self._uploader.put(batch["packed"])}

    def upload(self, batch: dict):
        """A loader's batch as ``train_step`` and ``eval_step`` take it: the
        uploaded (B, row) rows, or for the dense transfer the dict of
        uploaded arrays."""
        put = self.put_batch(batch)
        return put if self.transfer == "dense" else put["packed"]

    # ------------------------------------------------------------------ train
    def create_state(self, steps_per_epoch: int) -> Optimizer:
        """Build the optimizer (clip + AdamW + warmup-cosine schedule over
        ``steps_per_epoch * cfg.train.epochs`` steps) and zero the step
        count; with fp16, start the loss scaler at 2**15."""
        t = self.cfg.train
        self.optimizer = Optimizer(self.model, t.lr, t.wd, t.warmup,
                                   steps_per_epoch * t.epochs)
        if self.compute_dtype == torch.float16:
            self.loss_scale = init_loss_scale(device=self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("model %s/%s: %.2fM params on %s in %s, %d process(es), global batch %d, "
                 "%d steps/epoch", self.cfg.model.arch, self.cfg.model.domain, n_params / 1e6,
                 self.device, self.compute_dtype, self.world, self.global_batch(),
                 steps_per_epoch)
        return self.optimizer

    @property
    def step(self) -> int:
        """Steps taken since ``create_state``, skipped ones included."""
        return self.optimizer.count if self.optimizer is not None else 0

    def draw(self, batch: int) -> StepDraws:
        """The next step's draws for this rank's ``batch`` rows.  The host
        generators draw for the whole global batch (``batch`` x ranks) and
        the rank keeps its rows ``[rank * batch, (rank + 1) * batch)``, so
        every rank's generators stay in step and the draws are one
        process's.  SwinV2's block ``i`` keeps each sample's branch with
        probability ``1 - drop_path_rates[i]`` (always, at rate 0)."""
        total = batch * self.world
        flip, policy, crop = self.train_pipe.draw(self.generator, total)
        keep = None
        rates = getattr(self.model, "drop_path_rates", None)
        if rates is not None:
            u = torch.rand((len(rates), 2, total), generator=self.generator)
            keep = u >= torch.tensor(rates, dtype=u.dtype)[:, None, None]
        lam = draw_mixup_lambda(self.rng, self.cfg.train.mixup_alpha)
        if self.world > 1:
            rows = slice(self.rank * batch, (self.rank + 1) * batch)
            flip, policy = flip[rows], tuple(p[rows] for p in policy)
            keep = None if keep is None else keep[..., rows]
            crop = None if crop is None else tuple(t[rows] for t in crop)
        return StepDraws(flip, policy, lam, keep, self.dropout_masks(), crop)

    def dropout_masks(self) -> DropoutMasks | None:
        """The dropout masks of the next step (None at ``cfg.train.drop``
        0): drawn in the forward on the device, from a generator seeded from
        ``(cfg.seed, step, rank)``, the counterpart of JAX's ``fold_in(rng,
        state.step)`` (``loop.py:247``).  A resumed run draws the same masks
        with no generator state saved; the ranks of a data-parallel run
        draw their own."""
        if self._dropout_generator is None:
            return None
        seq = np.random.SeedSequence([self.cfg.seed, self.step, self.rank])
        self._dropout_generator.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
        return DropoutMasks(generator=self._dropout_generator)

    def compute_grads(self, packed, draws: StepDraws) -> torch.Tensor:
        """Pipeline -> mixup -> forward -> loss -> backward on an uploaded
        batch (``upload``): leaves each parameter's gradient in ``.grad`` and
        returns the loss as a 0-d tensor on the device.  With the loss
        scaler's state (fp16), the backward runs on the loss times the scale
        and the gradients are divided by it; the loss returned is the
        scaled loss divided by the scale, as the JAX step reports it.  In a
        process group the gradients are averaged over the ranks right after
        the backward, and mixup pairs across them; the loss returned is
        this rank's."""
        *inputs, labels, _ = self.train_pipe(packed, draws.flip, draws.policy, draws.crop)
        num_classes = self.cfg.model.classes
        if self.cfg.model.mixup:
            inputs, targets = mixup_batch(tuple(inputs), labels, num_classes, draws.lam,
                                          parallel.ring_roll if self.distributed else None)
        else:
            targets = torch.nn.functional.one_hot(
                labels.to(torch.int64), num_classes).to(torch.float32)
        self.model.train()
        extra = {} if draws.drop_keep is None else {
            "drop_keep": draws.drop_keep.to(self.device, non_blocking=True)}
        if draws.dropout is not None:
            extra["dropout"] = draws.dropout
        loss = softmax_cross_entropy(self.model(*inputs, **extra), targets)
        self.model.zero_grad(set_to_none=True)
        if self.loss_scale is None:
            loss.backward()
            self._sync_grads()
            return loss.detach()
        scale = self.loss_scale.scale
        scaled = loss * scale
        scaled.backward()
        self._sync_grads()
        torch._foreach_div_([p.grad for p in self.model.parameters()], scale)
        return (scaled / scale).detach()

    def _sync_grads(self) -> None:
        """Average the gradients over the ranks (none outside a process group)."""
        if self.distributed:
            parallel.all_reduce_mean_([p.grad for p in self.model.parameters()])

    def train_step(self, packed, draws: StepDraws | None = None) -> torch.Tensor:
        """One optimizer step on an uploaded batch (``upload``); returns the
        loss as a 0-d tensor on the device.  ``draws`` replaces the step's
        own draws (the tests hand over JAX's).  No host sync, but with the
        loss scaler (fp16): there the host reads whether every gradient is
        finite, skips the update if not (``Optimizer.step``), and the scale
        backs off or grows on the device (``train/scaler.py``)."""
        if self.optimizer is None:
            raise RuntimeError("call create_state before train_step")
        if draws is None:
            rows = packed["labels"] if self.transfer == "dense" else packed
            draws = self.draw(rows.shape[0])
        loss = self.compute_grads(packed, draws)
        if self.loss_scale is None:
            self.optimizer.step()
            return loss
        finite = all_finite(p.grad for p in self.model.parameters())
        self.optimizer.step(finite)
        self.loss_scale = update_loss_scale(self.loss_scale, finite)
        return loss

    # ------------------------------------------------------------------ eval
    def eval_step(self, packed) -> dict[str, torch.Tensor]:
        """Pipeline -> model (in eval mode, in the compute dtype, float32
        logits) -> weighted sums for one uploaded batch (``upload``)."""
        self.model.eval()
        *inputs, labels, weights = self.eval_pipe(packed)
        return eval_sums(self.model(*inputs), labels, weights)

    @torch.inference_mode()
    def evaluate(self, loader) -> dict:
        """Accuracy, mean loss and weighted count over every batch of
        ``loader`` (an iterable of the transfer's loader batches).
        The per-batch sums stay on the device until the merge; in a process
        group they are added up over the ranks first (each rank's loader
        holds its shard, padded with weight-0 rows to one batch count)."""
        sums = [self.eval_step(self.upload(batch)) for batch in loader]
        if self.distributed and sums:
            keys = ("correct", "loss_sum", "count")
            table = parallel.all_reduce_sum_(
                torch.stack([torch.stack([s[k] for k in keys]) for s in sums]))
            sums = [dict(zip(keys, row)) for row in table]
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


def rgb_canvas(canvas: int) -> int:
    """The RGB full-canvas transfers' canvas in pixels: 512 for the default
    64 (blocks), else ``canvas`` itself (``loop.py:170``)."""
    return 512 if canvas == 64 else canvas


def make_loaders(cfg: Config, index_train: str, index_val: str, *, num_threads: int = 4,
                 global_batch: int | None = None, transfer: str = "cropped",
                 canvas: int = 64, packed_k: int | None = None,
                 packed_k_eval: int | None = None, eval_fmt: str | None = None,
                 train_fmt: str | None = None):
    """Build the train / minival / trainval / test loaders of a DCT transfer
    (``datasets.py:445-582``; the JAX ``make_loaders`` :427-503): each
    process's batch is ``global_batch`` (default ``cfg.train.batch_size``)
    over the ranks, and it reads its strided shard of every split
    (``shard_id`` its rank); train shuffled with the last partial batch
    dropped, eval in order padded with weight-0 rows.

    ``"cropped"``: train rows of the random-resized-crop boxes, ``packed_k``
    ACs (default 16) in ``train_fmt`` (default mask16); eval to
    ``cfg.model.dct_blocks`` blocks by the deterministic center crop (ViT,
    ``datasets.py:364``) or the whole-image resize (SwinV2,
    ``datasets.py:381``), ``packed_k_eval`` in ``eval_fmt`` (defaults
    ``cropped_eval_defaults``).  ``"packed"``: ``DctPackedLoader`` rows of
    the whole image on a ``canvas``-block canvas at ``packed_k`` ACs a block,
    in the format of ``packed_defaults``.  ``"dense"``: ``DctCanvasLoader``.
    Both refuse the cropped wire's ``packed_k_eval``, ``eval_fmt`` and
    ``train_fmt``.  The RGB domain (the JAX ``loop.py:442-484``):
    ``"cropped"`` ``RgbCroppedLoader`` (train boxes, the ViT's center box or
    SwinV2's whole image for eval), ``"packed"`` ``DctPackedLoader``'s
    mask16 rows on the ``rgb_canvas`` // 8 block canvas, ``"dense"``
    ``RgbCanvasLoader``, all at ``packed_k`` (default 63)."""
    # imported here: the loader's codec needs libjpeg, the rest of this
    # module does not
    from rgbnomore_tpu_torch.data.loader import (
        DctCanvasLoader,
        DctCroppedLoader,
        DctPackedLoader,
        RgbCanvasLoader,
        RgbCroppedLoader,
    )

    if transfer not in TRANSFERS:
        raise ValueError(f"transfer must be one of {TRANSFERS}, got {transfer!r}")
    domain = cfg.model.domain
    check_cropped_only(transfer, domain, packed_k_eval=packed_k_eval, eval_fmt=eval_fmt,
                       train_fmt=train_fmt)
    train_all = load_index(index_train)
    test_ds = load_index(index_val)
    train_ds, minival_ds, trainval_ds = split_train_minival(
        train_all, split=cfg.train.split, seed=cfg.seed
    )
    world = parallel.world_size()
    bsz = (global_batch or cfg.train.batch_size) // world
    ek, ef = cropped_eval_defaults("DCT")
    k_train, fmt_train = packed_k or TRAIN_K, train_fmt or TRAIN_FMT
    k_eval, fmt_eval = packed_k_eval or ek, eval_fmt or ef
    eval_mode = "full" if cfg.model.arch == "swinv2" else "center"

    common = dict(seed=cfg.seed, num_threads=num_threads, shard_id=parallel.rank(),
                  num_shards=world)
    d_fmt, d_k = packed_defaults("DCT")

    def mk_rgb(ds, train: bool):
        k = packed_k or packed_defaults("RGB")[1]
        kw = dict(shuffle=train, drop_last=train, **common)
        if transfer == "cropped":
            return RgbCroppedLoader(ds, bsz, size=cfg.model.input_size, k=k,
                                    mode="train" if train else eval_mode, **kw)
        if transfer == "dense":
            return RgbCanvasLoader(ds, bsz, image_size=rgb_canvas(canvas), **kw)
        return DctPackedLoader(ds, bsz, canvas=rgb_canvas(canvas) // 8, k=k,
                               fmt=packed_defaults("RGB")[0], **kw)

    def mk(ds, train: bool):
        if domain == "RGB":
            return mk_rgb(ds, train)
        if transfer == "packed":
            return DctPackedLoader(ds, bsz, canvas=canvas, k=packed_k or d_k,
                                   fmt=d_fmt, shuffle=train, drop_last=train,
                                   **common)
        if transfer == "dense":
            return DctCanvasLoader(ds, bsz, canvas=canvas, shuffle=train, drop_last=train,
                                   **common)
        return DctCroppedLoader(
            ds, bsz, target=cfg.model.dct_blocks,
            k=k_train if train else k_eval, fmt=fmt_train if train else fmt_eval,
            mode="train" if train else eval_mode, shuffle=train, drop_last=train, **common)

    return {"train": mk(train_ds, True), "minival": mk(minival_ds, False),
            "trainval": mk(trainval_ds, False), "test": mk(test_ds, False)}


def save_params(path: str | Path, model: torch.nn.Module) -> None:
    """Save the final weights as a bare ``state_dict`` (the reference's
    save, ``train.py:202-204``), written to a temporary file and renamed."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(model.state_dict(), tmp)
    tmp.replace(path)


def load_params(path: str | Path, model: torch.nn.Module) -> None:
    """Load a bare ``state_dict`` (``save_params``, or ``convert.py``'s
    mapping of flax parameters) into ``model``."""
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def _flush_losses(pending: list, window: LocalWindow, world: int) -> float:
    """Feed the pending per-step losses, averaged over the ranks, to the
    window (one device read); returns the window's mean."""
    if pending:
        losses = parallel.all_reduce_sum_(torch.stack(pending))
        for v in (losses / world).tolist():
            window.put(v)
        pending.clear()
    return window.mean()


def train_and_eval(
    cfg: Config,
    index_train: str,
    index_val: str,
    savepath: str = "./models/model.pt",
    loadpath: str = "",
    load_ckpt_dir: str = "",
    run_train: bool = True,
    run_eval: bool = True,
    verbose: int = 1,
    num_threads: int = 4,
    max_steps_per_epoch: int | None = None,
    packed_k: int | None = None,
    packed_k_eval: int | None = None,
    eval_fmt: str | None = None,
    train_fmt: str | None = None,
    ckpt_every: int = 1,
    device=None,
    transfer: str = "cropped",
) -> dict:
    """The main train / eval flow (reference ``train.py:traineval``; the JAX
    ``train_and_eval``, ``loop.py:511-663``), on ``device`` (default
    ``cuda``), as one rank of the process group if there is one, over the
    host-to-device ``transfer`` (default ``"cropped"``; see ``Trainer``).

    Training: ``cfg.train.epochs`` epochs of at most ``max_steps_per_epoch``
    steps (which also caps the schedule's steps per epoch), from the
    checkpoint under ``load_ckpt_dir`` if given.  Each step's loss stays on
    the device; every 50 steps and at an epoch's last step the pending
    losses are read (averaged over the ranks) into a 100-step window.  Each
    epoch ends with the minival and trainval evals, the TensorBoard scalars
    (rank 0, under ``tensorboard_dir``) and, every ``ckpt_every`` epochs
    and at the last, a checkpoint under ``<dir(savepath)>/checkpoints/
    <arch>_dct``.  The final weights go to ``savepath`` (rank 0).

    Eval: test, then minival (and trainval without training) on the trained
    weights, or, eval-only, on ``loadpath`` or ``savepath``.

    Returns ``{"test", "val", "trainval"}`` (each ``{"accuracy", "loss",
    "count"}``) and, after training, ``"epoch"`` and ``"history"``: per
    epoch the train loss and this process's train and eval img/s.
    """
    trainer = Trainer(cfg, device=device, transfer=transfer, packed_k=packed_k,
                      packed_k_eval=packed_k_eval, eval_fmt=eval_fmt, train_fmt=train_fmt)
    if run_eval and not run_train and loadpath and not Path(loadpath).is_file():
        raise FileNotFoundError(f"no weights at {loadpath}")
    cfg = trainer.cfg
    loaders = make_loaders(
        cfg, index_train, index_val, num_threads=num_threads,
        global_batch=trainer.global_batch(), transfer=transfer, packed_k=trainer.packed_k,
        packed_k_eval=trainer.packed_k_eval, eval_fmt=trainer.eval_fmt,
        train_fmt=trainer.train_fmt)
    steps_per_epoch = len(loaders["train"])
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    if run_train or load_ckpt_dir:
        trainer.create_state(steps_per_epoch)

    if verbose >= 1:
        log.info("config: %s", cfg)
    if verbose >= 2:
        # the shape and parameter table on the declared input shapes, the
        # reference's torchinfo.summary (pipeline_utils.py:383-384)
        from rgbnomore_tpu_torch.utils.summary import model_summary

        log.info("model summary:\n%s", model_summary(trainer.model, cfg))
    savepath = str(savepath)
    if run_train:
        Path(savepath).resolve().parent.mkdir(parents=True, exist_ok=True)
    ckpt_dir = ckpt.checkpoint_dir(savepath, f"{cfg.model.arch}_{cfg.model.domain.lower()}")
    # TensorBoard and the final weights file are rank 0's (the reference's
    # rank-0 gating, train.py:117/:202); every rank calls the checkpoint
    is_rank0 = parallel.is_rank0()
    writer = SummaryWriter(tensorboard_dir(savepath, cfg) if run_train and is_rank0 else None)

    start_epoch = 0
    if load_ckpt_dir:
        meta = ckpt.restore_checkpoint(load_ckpt_dir, trainer)
        start_epoch = int(meta["epoch"]) + 1
        log.info("resumed from %s at epoch %d (step %d)", load_ckpt_dir, start_epoch,
                 trainer.step)

    results: dict = {}
    if run_train:
        window = LocalWindow(100)
        n_train_batches = len(loaders["train"])
        history = []
        for epoch in range(start_epoch, cfg.train.epochs):
            loaders["train"].set_epoch(epoch)
            t0 = time.perf_counter()
            n_img = 0
            pending: list = []  # per-step device losses, read at the logging cadence
            for i, batch in enumerate(loaders["train"]):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                pending.append(trainer.train_step(trainer.upload(batch)))
                n_img += int(batch["weights"].sum())
                if verbose >= 2 or i % 50 == 0 or i + 1 == n_train_batches:
                    running = _flush_losses(pending, window, trainer.world)
                    writer.scalar("Loss/Peritr_Train", running, trainer.step)
                    if verbose >= 2:
                        log.info("[Epoch %d/%d It %d] loss %.4f lr %.3e", epoch + 1,
                                 cfg.train.epochs, i + 1, running,
                                 trainer.optimizer.schedule(trainer.step))
            train_loss = _flush_losses(pending, window, trainer.world)  # after an early break
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            val = trainer.evaluate(loaders["minival"])
            tval = trainer.evaluate(loaders["trainval"])
            eval_dt = time.perf_counter() - t0
            train_img_s = n_img / max(dt, 1e-9)
            eval_img_s = (val["count"] + tval["count"]) / trainer.world / max(eval_dt, 1e-9)
            if verbose >= 1:
                log.info("epoch %d: loss %.4f | val acc %.2f%% loss %.4f | trainval acc %.2f%% "
                         "| train %.1f img/s, eval %.1f img/s (this process)", epoch + 1,
                         train_loss, val["accuracy"] * 100, val["loss"],
                         tval["accuracy"] * 100, train_img_s, eval_img_s)
            writer.scalar("Loss/Train", train_loss, epoch)
            writer.scalar("Loss/Val", val["loss"], epoch)
            writer.scalar("Acc/Val", val["accuracy"], epoch)
            writer.scalar("Loss/Train_val", tval["loss"], epoch)
            writer.scalar("Acc/Train_val", tval["accuracy"], epoch)
            writer.scalar("Learning Rate", trainer.optimizer.schedule(trainer.step), epoch)
            # the reference checkpoints every epoch (train.py:196-199);
            # ckpt_every thins the cadence, always keeping the last
            if (epoch + 1) % ckpt_every == 0 or epoch + 1 == cfg.train.epochs:
                ckpt.save_checkpoint(ckpt_dir, trainer, epoch, {
                    "val_acc": val["accuracy"], "val_loss": val["loss"],
                    "train_loss": train_loss})
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "train_img_s": train_img_s, "eval_img_s": eval_img_s})
            results.update({"val": val, "trainval": tval, "epoch": epoch, "history": history})
        if is_rank0:
            save_params(savepath, trainer.model)
            log.info("training complete; saved weights to %s", savepath)
        parallel.barrier()

    if run_eval and not run_train:
        weights = loadpath or savepath
        if weights and Path(weights).is_file():
            load_params(weights, trainer.model)
            log.info("loaded weights from %s", weights)
        else:
            log.warning("no weights file %r: evaluating the weights drawn from the seed",
                        weights)
    if run_eval:
        test = trainer.evaluate(loaders["test"])
        results["test"] = test
        writer.scalar("Acc/Test", test["accuracy"], 0)
        writer.scalar("Loss/Test", test["loss"], 0)
        if verbose >= 1:
            log.info("test acc %.2f%% loss %.4f (n=%d)", test["accuracy"] * 100,
                     test["loss"], int(test["count"]))
        # eval-only mode also scores minival + trainval (train.py:206-219);
        # after a train run 'val' is already the last epoch's
        if "val" not in results:
            results["val"] = trainer.evaluate(loaders["minival"])
        if not run_train:
            results["trainval"] = trainer.evaluate(loaders["trainval"])

    writer.close()
    return results
