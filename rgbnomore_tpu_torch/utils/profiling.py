"""Profiling and FLOP accounting, the port's counterpart of the JAX
package's ``utils/profiling.py``, and the port's one store of spans and
counters.

``span(name, index)`` times a block of the host's work and ``count(name,
n)`` adds to a counter; ``totals()`` reads both and ``reset()`` clears
them.  A span always adds its host seconds and one call to its name's
totals; while a ``torch.profiler`` session records, and only then, it also
opens a profiler event of that name (category ``user_annotation``), which
lands in the trace beside the device's kernels on the same clock: a kernel's
launch falls inside the span that issued it, and a gap in the device's work
falls under the host span open at that moment.  A span's ``index`` (the
step or batch index) is the event's input, written as its ``Concrete
Inputs`` where the session records shapes (``trace`` does).  Every name
starts with ``rgbnm.``.  Neither a span nor a counter reads a device tensor
or waits for the device; the totals take a lock, so the loader's producer
thread and autograd's backward thread may add to them.

``trace`` records a ``torch.profiler`` trace (host operators, the spans of
every thread and, on a card, the device's kernels) for TensorBoard; and
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
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["compiled_cost", "count", "model_flops", "on_cpu", "reset", "span", "totals",
           "trace"]

_lock = threading.Lock()
_spans: dict[str, list] = {}  # name -> [calls, host seconds]
_counters: dict[str, int] = {}
_enter_event = torch.autograd._record_function_with_args_enter
_exit_event = torch.autograd._record_function_with_args_exit


class span:
    """``with span("rgbnm.step", i):`` adds the block's host seconds and one
    call to the totals of ``name``; while the profiler records, the block is
    also a profiler event of that name whose one input is ``index`` (the
    step or batch index) where given.  The check for a recording profiler
    reads one process-wide flag, so a span opened on another thread (the
    loader's producer) is recorded where the session traces every thread
    (``trace`` does)."""

    __slots__ = ("name", "index", "_t0", "_event")

    def __init__(self, name: str, index: int | None = None):
        self.name, self.index = name, index

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._event = _enter_event(self.name) if self.index is None else \
                _enter_event(self.name, self.index)
        else:
            self._event = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._event is not None:
            _exit_event(self._event)
        _lock.acquire()
        try:
            total = _spans.get(self.name)
            if total is None:
                _spans[self.name] = [1, dt]
            else:
                total[0] += 1
                total[1] += dt
        finally:
            _lock.release()
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a host integer: calls, bytes)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """A snapshot of every span and counter since the last ``reset``:
    ``{"spans": {name: {"calls", "host_s"}}, "counters": {name: n}}``."""
    with _lock:
        return {"spans": {k: {"calls": c, "host_s": s} for k, (c, s) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear every span's totals and every counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


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
    ``*.pt.trace.json``): host operators and the port's spans on every
    thread, with their inputs (a span's step or batch index), and the CUDA
    kernels where a card is visible.  With a card the profiler first runs a
    warm-up step of ``TRACE_WARMUP_LAUNCHES`` tiny kernels on each device,
    then records from ``margin_s`` before the block's first launch to
    ``margin_s`` after the devices have run its last kernel, so that it
    drops none of the block's kernels.  Yields the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(logdir), record_shapes=True,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
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
