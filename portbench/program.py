"""The system under test: the PyTorch and CUDA port, ``rgbnomore_tpu_torch``.

The only module of the benchmark that imports the port.  It builds the
port's config and ``Trainer`` from a configuration file, loads the
benchmark's weights into the model, hands the benchmark's draws over as the
Trainer's ``StepDraws``, and, in a traced run only, opens the benchmark's
own spans around the calls into the port's layers: ``pb.pipeline`` around
the input pipeline, ``pb.attn.fwd`` around each attention call and
``pb.attn.bwd`` around its backward (through a pair of identity autograd
functions around it), ``pb.optimizer`` around the clip and AdamW and, in a
process group, ``pb.exchange`` around the gradient all-reduce and mixup's
ring.  ``cell.py`` opens ``pb.window``, ``pb.step``, ``pb.draws`` and
``pb.upload``.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.profiler import record_function

__all__ = ["build_kernels", "install_spans", "make_trainer", "step_draws"]

# keys of a configuration's ``train`` section that the benchmark reads and the
# port's ``TrainConfig`` does not hold: checked against the Trainer instead
BENCH_ONLY = {"steps_per_epoch", "clip_norm"}


def _port_config(cfg: dict):
    """The port's ``Config``: the preset with its overrides, then every key
    of the file's ``model`` and ``train`` sections; a key that the port's
    config does not hold is refused."""
    from rgbnomore_tpu_torch.train.config import generate_config

    pc = generate_config(cfg["preset"], **cfg.get("overrides", {}))
    for section, target in (("model", pc.model), ("train", pc.train)):
        bench_only = BENCH_ONLY if section == "train" else set()
        unknown = sorted(k for k in cfg[section] if not hasattr(target, k) and k not in bench_only)
        if unknown:
            raise ValueError(f"the port's {section} config has no keys {unknown}")
        for key, value in cfg[section].items():
            if key not in bench_only:
                setattr(target, key, list(value) if isinstance(value, list) else value)
    pc.seed = 0  # the port's own draws are not used: the benchmark hands over its own
    return pc


def build_kernels() -> None:
    """Build every kernel library of the port that is not built yet."""
    from rgbnomore_tpu_torch.ops import cuda_build

    cuda_build.build()


def make_trainer(cfg: dict, device, weights: dict, options: dict):
    """A ``Trainer`` with the wire module's ``options`` (transfer, K,
    format), ``weights`` copied into its model and its optimizer state made
    for the file's steps an epoch."""
    from rgbnomore_tpu_torch.train.loop import Trainer

    trainer = Trainer(_port_config(cfg), device=device, **options)
    params = dict(trainer.model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the port's parameters {sorted(set(params) ^ set(weights))} "
                           "do not match the reference model's")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise RuntimeError(f"{name}: port {tuple(p.shape)}, reference "
                                   f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
    trainer.create_state(cfg["train"]["steps_per_epoch"])
    if trainer.optimizer.clip_norm != cfg["train"]["clip_norm"]:
        raise ValueError(f"the port clips at {trainer.optimizer.clip_norm}, the "
                         f"configuration at {cfg['train']['clip_norm']}")
    return trainer


def step_draws(draws: dict):
    """The benchmark's draws as the Trainer's ``StepDraws``."""
    from rgbnomore_tpu_torch.train.loop import StepDraws

    return StepDraws(draws["flip"], draws["policy"], draws["lam"], draws["drop_keep"])


class _Span:
    """A span opened in one autograd call and closed in another."""

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _OpenInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, x):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.span.open()
        return None, grad


class _CloseInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, *xs):
        ctx.span = span
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.span.close()
        return (None, *grads)


def _spanned_attention(fn):
    """``fn`` inside ``pb.attn.fwd``; its backward inside ``pb.attn.bwd``:
    the span opens when the output's gradient arrives and closes when the
    inputs' gradients leave."""

    @functools.wraps(fn)
    def call(*args):
        if not torch.is_grad_enabled() or not any(
                isinstance(a, torch.Tensor) and a.requires_grad for a in args):
            with record_function("pb.attn.fwd"):
                return fn(*args)
        span = _Span("pb.attn.bwd")
        idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad]
        marked = _CloseInBackward.apply(span, *(args[i] for i in idx))
        args = list(args)
        for i, t in zip(idx, marked):
            args[i] = t
        with record_function("pb.attn.fwd"):
            out = fn(*args)
        return _OpenInBackward.apply(span, out)

    return call


class _SpannedPipeline:
    """An input pipeline called inside ``pb.pipeline``; its other
    attributes (``draw``, ``k``, ...) are the pipeline's own."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __call__(self, *args, **kwargs):
        with record_function("pb.pipeline"):
            return self._pipe(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._pipe, name)


def install_spans(trainer) -> None:
    """Open the benchmark's spans around the Trainer's layers (traced runs
    only): every module with an ``attention`` function, both pipelines, the
    optimizer step, the collectives of ``parallel``.  Raises where one of
    these is gone from the port, so that a metric read from its span fails
    the run instead of falling silent."""
    wrapped = 0
    for m in trainer.model.modules():
        if callable(getattr(m, "attention", None)):
            m.attention = _spanned_attention(m.attention)
            wrapped += 1
    if not wrapped:
        raise RuntimeError("no module of the port's model has an attention function "
                           "for the benchmark's attention spans")
    for name in ("train_pipe", "eval_pipe"):
        if not callable(getattr(trainer, name, None)):
            raise RuntimeError(f"the port's Trainer has no {name} for the pipeline span")
    trainer.train_pipe = _SpannedPipeline(trainer.train_pipe)
    trainer.eval_pipe = _SpannedPipeline(trainer.eval_pipe)
    trainer.optimizer.step = _spanned(trainer.optimizer.step, "pb.optimizer")
    if trainer.distributed:
        from rgbnomore_tpu_torch import parallel

        for name in ("all_reduce_mean_", "ring_roll"):
            setattr(parallel, name, _spanned(getattr(parallel, name), "pb.exchange"))


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return call
