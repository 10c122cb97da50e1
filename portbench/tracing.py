"""The traced run: a ``torch.profiler`` trace of a few steps, read back.

``record`` runs a block under the profiler (host operators and the card's
kernels) the way the port's ``utils/profiling.py:trace`` does since it was
found to drop kernels: a warm-up step of 256 tiny launches that the trace
leaves out, then the block with 10 ms of idle device at each end.  The trace
is written as Chrome-trace JSON into the run's temporary directory, read,
and deleted.

``Trace`` holds what the readers need: the window (the ``pb.window`` span),
the device's busy time inside it (the union of its kernels, copies and
sets), the device time of the kernels launched inside each of the
benchmark's spans (a launch belongs to a span when its runtime call lies
inside the span on the same host thread), and the breakdown: the kernels
that took most time and the longest idle gaps, each named by the innermost
benchmark span open on the host half-way through the gap.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["Trace", "parse", "record"]

WARMUP_LAUNCHES = 256
MARGIN_S = 0.01
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _settle() -> None:
    torch.cuda.synchronize()
    time.sleep(MARGIN_S)


def record(block) -> "Trace":
    """Run ``block()`` under the profiler and return its ``Trace``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x.add_(1)
            _settle()
            prof.step()
            _settle()
            block()
            _settle()
        with open(path) as f:
            return parse(json.load(f))
    finally:
        os.unlink(path)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    span_device_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def parse(trace: dict) -> Trace:
    """Read a Chrome-trace dict (times in microseconds)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("pb.")]
    windows = [e for e in spans if e["name"] == "pb.window"]
    if not windows:
        raise RuntimeError("the trace has no pb.window span")
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
               for e in device]
    clipped = [(s, t) for s, t in clipped if t > s]
    out = Trace(window_s=(w1 - w0) / 1e6, busy_s=_union(clipped) / 1e6)

    by_corr = defaultdict(list)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr].append(float(e["dur"]))
    launches = [e for e in events if e.get("cat") in _LAUNCH_CATS]
    by_tid = defaultdict(list)
    for e in launches:
        by_tid[e.get("tid")].append(e)
    for t in by_tid.values():
        t.sort(key=lambda e: float(e["ts"]))
    dev_s = defaultdict(float)
    for sp in spans:
        s0, s1 = float(sp["ts"]), float(sp["ts"]) + float(sp["dur"])
        for e in by_tid.get(sp.get("tid"), ()):
            ts = float(e["ts"])
            if ts < s0:
                continue
            if ts > s1:
                break
            corr = e.get("args", {}).get("correlation")
            dev_s[sp["name"]] += sum(by_corr.get(corr, ())) / 1e6
    out.span_device_s = dict(dev_s)

    per_kernel = defaultdict(float)
    for e in device:
        if w0 <= float(e["ts"]) <= w1:
            per_kernel[e["name"]] += float(e["dur"]) / 1e6
    out.device_ops = sorted(([k, v] for k, v in per_kernel.items()), key=lambda kv: -kv[1])[:10]

    main_tid = w.get("tid")
    inner = sorted((e for e in spans if e.get("tid") == main_tid and e is not w),
                   key=lambda e: float(e["ts"]))
    gaps, last = [], w0
    for s, t in sorted(clipped):
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))

    def open_span(ts):
        name = "pb.window"
        for e in inner:
            if float(e["ts"]) > ts:
                break
            if float(e["ts"]) + float(e["dur"]) >= ts:
                name = e["name"]  # later starts are nested deeper
        return name

    gaps.sort(key=lambda g: g[0] - g[1])
    out.idle_gaps = [[open_span((s + t) / 2), (t - s) / 1e6] for s, t in gaps[:10]]
    return out
