"""Evaluation orchestration: the eval half of ``rgbnomore_tpu/train/loop.py``.

``Trainer`` owns the model and the input pipeline on one device; its
``evaluate`` uploads each consolidated ``(B, row)`` uint8 batch in one
pinned, non-blocking copy and runs pipeline -> ViT -> weighted sums on the
device.  ``make_loaders`` builds the eval loaders of the cropped DCT
transfer.  Training, checkpoints and multi-GPU data parallelism come with
later slices (ROADMAP.md, port queue).
"""

from __future__ import annotations

import logging

import torch

from rgbnomore_tpu_torch.augment.pipeline import make_cropped_eval_pipeline
from rgbnomore_tpu_torch.data.index import load_index, split_train_minival
from rgbnomore_tpu_torch.device import resolve_device
from rgbnomore_tpu_torch.train.config import Config, build_model
from rgbnomore_tpu_torch.train.steps import eval_sums, merge_eval_metrics

log = logging.getLogger(__name__)

__all__ = ["Trainer", "cropped_eval_defaults", "guard_eval_sums", "make_loaders"]


def cropped_eval_defaults(domain: str) -> tuple[int, str]:
    """(K, fmt) of the EVAL side of the crop-before-pack wire, shared by
    Trainer and make_loaders (the two ends of the wire must agree).

    The JAX package's K-sweep against the dense full-spectrum path
    (KSWEEP.json) measured top-1 agreement 81.5% at the train default K=16
    and 100.0% with zero logit drift at K=48, so eval ships K=48.
    """
    return (48, "mask16") if domain == "DCT" else (63, "mask16")


class Trainer:
    """Owns the model and the eval pipeline for one config on one device.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU.  The
    model's parameters are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed``; ``model.load_state_dict`` replaces them.  The input is the
    cropped DCT wire (the JAX Trainer's ``transfer="cropped"``).
    """

    def __init__(self, cfg: Config, device=None):
        self.device = resolve_device(device)
        if cfg.model.domain != "DCT":
            raise NotImplementedError(
                "the RGB domain is still to be ported (ROADMAP.md, port queue: RGB)")
        self.model = build_model(cfg, device=self.device)
        self.packed_k_eval, self.eval_fmt = cropped_eval_defaults(cfg.model.domain)
        self.eval_pipe = make_cropped_eval_pipeline(
            cfg, k=self.packed_k_eval, fmt=self.eval_fmt)

    def put_batch(self, batch: dict) -> dict:
        """Upload the consolidated (B, row) uint8 buffer: one copy, from
        pinned memory and non-blocking on the GPU (labels and weights ride
        inside the row)."""
        buf = torch.from_numpy(batch["packed"])
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        return {"packed": buf}

    def eval_step(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        """Pipeline -> model -> weighted sums for one uploaded batch."""
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
    """Build the minival / trainval / test eval loaders of the cropped DCT
    transfer (``datasets.py:445-582``): batches of ``cfg.train.batch_size``,
    the deterministic center crop to ``cfg.model.dct_blocks`` blocks, the
    ``cropped_eval_defaults`` wire.  The train loader comes with the train
    slice."""
    # imported here: the loader's codec needs libjpeg, the rest of this
    # module does not
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader

    if cfg.model.arch == "swinv2" or cfg.model.domain != "DCT":
        raise NotImplementedError(
            "only the ViT's cropped DCT eval loaders are ported so far "
            "(ROADMAP.md, port queue)")
    train_all = load_index(index_train)
    test_ds = load_index(index_val)
    _, minival_ds, trainval_ds = split_train_minival(
        train_all, split=cfg.train.split, seed=cfg.seed
    )
    k, fmt = cropped_eval_defaults("DCT")

    def mk(ds):
        return DctCroppedLoader(
            ds, cfg.train.batch_size, target=cfg.model.dct_blocks, k=k, fmt=fmt,
            mode="center", shuffle=False, drop_last=False, seed=cfg.seed,
            num_threads=num_threads,
        )

    return {"minival": mk(minival_ds), "trainval": mk(trainval_ds), "test": mk(test_ds)}
