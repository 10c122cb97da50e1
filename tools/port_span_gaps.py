#!/usr/bin/env python3
"""Where a benchmark cell's idle device time goes, named by the port's spans.

Run from the root of a checkout, on a machine with the cell's cards:

    python3 tools/port_span_gaps.py --workload vits16-train --seed 7 --out chiprun_out/gaps

It makes one traced run of the cell through ``portbench/run.py`` (``--trace
1``: the benchmark's spans, trace and result line, unchanged) and reads the
same profiler trace once more before the benchmark deletes it, for what the
benchmark does not read:

- every gap in the device's work of ``--min-gap-ms`` or more inside
  ``pb.window``, with the step it falls in and three names: the innermost
  port span (``rgbnm.*``) open on the main thread half-way through the gap,
  the innermost port span open on any thread then, and the benchmark's own
  name for it (the innermost ``pb.*`` span, as ``portbench/tracing.py``
  names gaps);
- the device time of the launches inside each port span and each benchmark
  span, by the benchmark's rule (a launch belongs to a span when its runtime
  call lies inside the span on the same host thread), in ms a step;
- each ``rgbnm.step``'s (or ``rgbnm.eval_step``'s) host time and how often
  each port span lies inside it;
- for each gap, the host's operator half-way through it and its CUDA
  runtime calls from just before the gap to its end.

Then, in the parent process, the host cost of one span with the profiler
off and while it records, against an empty loop.  Writes one JSON file per
rank into ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "portbench"))
sys.path.insert(1, str(REPO))

import ranks  # noqa: E402
import run as bench_run  # noqa: E402
import tracing  # noqa: E402

_ARGS: dict = {}  # this run's workload, seed, out and gap floor, for the ranks too


def _innermost(spans: list, t: float, tid=None):
    """The name of the latest-starting span of ``spans`` open at ``t`` (on
    ``tid`` where given), or None."""
    best = None
    for e in spans:
        if (tid is None or e.get("tid") == tid) and e["ts"] <= t <= e["end"]:
            if best is None or e["ts"] >= best["ts"]:
                best = e
    return None if best is None else best["name"]


def analyse(trace: dict, min_gap_ms: float) -> dict:
    """The gaps, device times a step and steps of one Chrome trace."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    for e in events:
        e["ts"], e["end"] = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    window = next(e for e in ann if e["name"] == "pb.window")
    w0, w1, main = window["ts"], window["end"], window.get("tid")
    port = [e for e in ann if e["name"].startswith("rgbnm.")]
    bench = [e for e in ann if e["name"].startswith("pb.")]
    steps = sorted((e for e in bench if e["name"] == "pb.step"), key=lambda e: e["ts"])

    device = [e for e in events if e.get("cat") in tracing._DEVICE_CATS]
    busy = sorted((max(e["ts"], w0), min(e["end"], w1)) for e in device)
    gaps, last = [], w0
    for s, t in busy:
        if t <= s:
            continue
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == main]
    runtime = [e for e in events if e.get("cat") in tracing._LAUNCH_CATS and e.get("tid") == main]
    named = []
    for s, t in gaps:
        if (t - s) / 1e3 < min_gap_ms:
            continue
        mid = (s + t) / 2
        step = next((i for i, e in enumerate(steps) if e["ts"] <= mid <= e["end"]), None)
        # what the host was doing: its operator half-way through the gap, and
        # its runtime calls from just before the gap to its end
        calls = sorted((e for e in runtime if e["end"] >= s - 20 and e["ts"] <= t),
                       key=lambda e: e["ts"] - e["end"])[:3]
        named.append({"ms": (t - s) / 1e3, "at_ms": (s - w0) / 1e3, "step": step,
                      "port_main": _innermost(port, mid, main), "port_any": _innermost(port, mid),
                      "bench": _innermost(bench, mid, main) or "pb.window",
                      "host_op": _innermost(ops, mid),
                      "runtime": [[e["name"], (e["end"] - e["ts"]) / 1e3, (e["ts"] - s) / 1e3]
                                  for e in calls]})

    by_corr = collections.defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["end"] - e["ts"]
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in tracing._LAUNCH_CATS:
            launches[e.get("tid")].append(e)
    device_ms = collections.defaultdict(float)
    for sp in port + bench:
        for e in launches.get(sp.get("tid"), ()):
            if sp["ts"] <= e["ts"] <= sp["end"]:
                device_ms[sp["name"]] += by_corr.get(e.get("args", {}).get("correlation"), 0.0)
    n = max(1, len(steps))
    per_step = []
    for e in (e for e in port if e["name"] in ("rgbnm.step", "rgbnm.eval_step")):
        inside = collections.Counter(s["name"] for s in port
                                     if s is not e and e["ts"] <= s["ts"] and s["end"] <= e["end"])
        per_step.append({"host_ms": (e["end"] - e["ts"]) / 1e3, "spans": dict(inside)})
    return {"window_ms": (w1 - w0) / 1e3, "steps": len(steps),
            "busy_ms": sum(t - s for s, t in _union(busy)) / 1e3,
            "gaps": sorted(named, key=lambda g: -g["ms"]),
            "device_ms_per_step": {k: v / 1e3 / n for k, v in sorted(device_ms.items())},
            "port_steps": per_step}


def _union(intervals):
    out = []
    for s, t in intervals:
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _install() -> None:
    """Read each trace with ``analyse`` too, before the benchmark parses it."""
    parse = tracing.parse

    def parse_and_keep(trace: dict):
        import torch

        dist = torch.distributed
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        got = analyse(trace, _ARGS["min_gap_ms"])
        out = Path(_ARGS["out"]) / f"{_ARGS['workload']}-s{_ARGS['seed']}-r{rank}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(got, indent=1))
        return parse(trace)

    tracing.parse = parse_and_keep


def _rank_worker(rank: int, world: int, port: int, args: dict, out) -> None:
    """``ranks._worker`` with the trace read by ``analyse`` too."""
    import ranks as fresh

    _ARGS.update(args["span_gaps"])
    _install()
    fresh._worker(rank, world, port, args, out)


def span_cost(n: int = 20000) -> dict:
    """Host µs of one empty ``profiling.span`` block, the profiler off and
    while it records (CPU and CUDA activities), less an empty loop's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.utils import profiling

    def per_call(body) -> float:
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            body()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    def spans():
        for _ in range(n):
            with profiling.span("rgbnm.cost"):
                pass

    def empty():
        for _ in range(n):
            pass

    base = per_call(empty)
    off = per_call(spans) - base
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    with profile(activities=activities):
        on = per_call(spans) - base
    return {"off_us": off, "on_us": on}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="chiprun_out/span_gaps")
    ap.add_argument("--min-gap-ms", type=float, default=0.1)
    ap.add_argument("--seconds", type=float, default=30)
    a = ap.parse_args()
    _ARGS.update(workload=a.workload, seed=a.seed, out=a.out, min_gap_ms=a.min_gap_ms)
    _install()
    run_ranks = ranks.run_ranks

    def run_ranks_with_gaps(world, **kw):
        ranks._worker = _rank_worker
        return run_ranks(world, span_gaps=dict(_ARGS), **kw)

    ranks.run_ranks = run_ranks_with_gaps  # run.py imports it from ranks when it runs
    rc = bench_run.main(["--workload", a.workload, "--seed", str(a.seed), "--seconds",
                         str(a.seconds), "--trace", "1"])
    cost = span_cost()
    print(f"span_gaps: one span {cost['off_us']:.3f} us on the host with the profiler off, "
          f"{cost['on_us']:.3f} us while it records", flush=True)
    for path in sorted(Path(a.out).glob(f"{a.workload}-s{a.seed}-r*.json")):
        got = json.loads(path.read_text())
        got["span_cost"] = cost
        path.write_text(json.dumps(got, indent=1))
        steps = got["port_steps"]
        spans_a_step = sum(sum(s["spans"].values()) + 1 for s in steps) / max(1, len(steps))
        print(f"span_gaps: {path.name}: {got['steps']} steps, window {got['window_ms']:.3f} ms, "
              f"busy {got['busy_ms']:.3f} ms; {spans_a_step:.1f} port spans a step "
              f"({spans_a_step * cost['on_us']:.1f} us traced, "
              f"{spans_a_step * cost['off_us']:.1f} us untraced)", flush=True)
        for g in got["gaps"][:12]:
            print(f"  gap {g['ms']:.3f} ms at {g['at_ms']:.3f} ms, step {g['step']}: port "
                  f"{g['port_main']} (any thread {g['port_any']}), benchmark {g['bench']}; "
                  f"host in {g['host_op']}, runtime {g['runtime']}", flush=True)
        dev = got["device_ms_per_step"]
        print("  device ms a step: " + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
