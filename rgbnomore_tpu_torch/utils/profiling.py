"""Profiling and FLOP accounting, the port's counterpart of the JAX
package's ``utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (host operators and, on a
card, the device's kernels) for TensorBoard; ``Timer`` is a wall-clock
timer whose ``sync`` waits for the device of the tensors it is given; and
``compiled_cost`` / ``model_flops`` count the products of a call with
``torch.utils.flop_counter.FlopCounterMode``.  The counter sees PyTorch's
operators only, not the port's hand-written kernels, which launch through
ctypes; so ``model_flops`` counts on a CPU copy of the model (``on_cpu``),
where every kernel is its plain version, and gives the same number
wherever the model lives.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import time

import torch

__all__ = ["trace", "Timer", "compiled_cost", "model_flops", "on_cpu"]


# The profiler can lose the first fifty or so kernel records of a session
# (seen on an H100 after other profiler sessions in the same process), so a
# trace first launches this many tiny kernels in a warm-up step that its file
# leaves out.
TRACE_WARMUP_LAUNCHES = 256
# How long the device is left idle at each end of the traced block (seconds):
# the profiler keeps a kernel only where the device's timestamps put it inside
# the host's window, and the device's clock can run behind the host's.
TRACE_MARGIN_S = 0.01


@contextlib.contextmanager
def trace(logdir: str, margin_s: float = TRACE_MARGIN_S):
    """Record a ``torch.profiler`` trace of the block into ``logdir``
    (TensorBoard's profile plugin reads it; the file is Chrome-trace JSON,
    ``*.pt.trace.json``): host operators always, the CUDA kernels where a
    card is visible.  With a card the profiler first runs a warm-up step of
    ``TRACE_WARMUP_LAUNCHES`` tiny kernels on each device, then records
    from ``margin_s`` before the block's first launch to ``margin_s`` after
    the devices have run its last kernel, so that it drops none of the
    block's kernels.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        if cuda:
            for device in range(torch.cuda.device_count()):
                x = torch.zeros(1, device=f"cuda:{device}")
                for _ in range(TRACE_WARMUP_LAUNCHES):
                    x.add_(1)
            _settle(margin_s)
        prof.step()  # warm-up -> record
        if cuda:
            _settle(margin_s)
        yield prof
        if cuda:
            _settle(margin_s)


def _settle(seconds: float) -> None:
    """Wait for every visible CUDA device, then ``seconds`` more."""
    for device in range(torch.cuda.device_count()):
        torch.cuda.synchronize(device)
    time.sleep(seconds)


def _tensors(tree):
    """The tensors in a tensor or a nested list, tuple or dict of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


class Timer:
    """Wall-clock timer; call ``sync`` on a call's outputs inside the block
    so that the device's work is in the span."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @staticmethod
    def sync(tree):
        """Wait for the devices of the CUDA tensors in ``tree``; returns
        ``tree``."""
        for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)
        return tree


def compiled_cost(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the products of one call ``fn(*args, **kwargs)``,
    counted by ``torch.utils.flop_counter.FlopCounterMode`` (2 per
    multiply-add of a matrix product, a convolution or an attention; no
    elementwise work).  There is no XLA here and so no compiled executable
    to analyse, and no "bytes accessed".  The port's kernels are not seen
    on the card: count a model there on ``on_cpu(model)``, as
    ``model_flops`` does."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def on_cpu(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` itself where its parameters and buffers are all on the CPU,
    else a copy of it there (each tensor copied once, straight to the CPU,
    with nothing more allocated on its device)."""
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    if all(t.device.type == "cpu" for t in tensors):
        return model
    memo = {}
    for t in tensors:
        host = t.detach().cpu()
        memo[id(t)] = torch.nn.Parameter(host, t.requires_grad) \
            if isinstance(t, torch.nn.Parameter) else host
    return copy.deepcopy(model, memo)


def model_flops(model: torch.nn.Module, *inputs) -> float:
    """FLOPs of one forward pass of ``model`` on ``inputs`` (eval mode, no
    grad), counted by ``compiled_cost`` on the CPU (``on_cpu``, the inputs
    copied there too), where the counter sees every product: the same
    number on the card as on the CPU, in any compute dtype."""
    model = on_cpu(model)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return compiled_cost(model, *(x.cpu() for x in inputs))["flops"]
    finally:
        model.train(training)
