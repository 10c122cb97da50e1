"""One run of one cell: set-up, the measured window, the check.

A cell names a configuration and a traffic mix (``manifest.py``).  The
traffic names its driver, ``drivers/<driver>.py``, which says what the
window drives: which entry of the port's ``Trainer`` a step calls, what
set-up does before the window, what the window's outputs are, and how the
plain reference recomputes them.  The configuration's ``wire`` section names
the rows' wire module, ``wires/<transfer>.<format>.py``: the port's options
for it, the traffic's packing and the reference's decode.  A key of the
configuration, the traffic or the wire that no part of the harness reads is
refused, not left out.

Set-up makes the rows and the weights from the seed, builds the port's
``Trainer`` with the benchmark's weights and lets the driver prepare: for a
train step, the check's three steps through the window's own call, then one
more to warm up; for an eval batch, two batches to warm up.  The device's
peak memory is then reset and ``setup_s`` read.

The window cycles the row pool through the driver's step until ``seconds``
have passed, then a synchronise.  The rate is all images of all completed
steps over the whole window.  A traced run traces the traffic's
``trace_steps`` steps instead (``tracing.record``) with the benchmark's
spans around the port's layers; every per-layer metric that the cell lists
has to read a number, or the run fails.

Once the window has closed and the peak memory is read, the Trainer is
freed and the driver's reference recomputes what the window's call produced
from the same rows, draws and weights; ``check.py`` turns the two into the
numbers compared, each against its limit.

In a process group (a cell on several cards, ``ranks.py``) every rank makes
the same global rows and draws and keeps its slice; the window runs as many
steps as rank 0's timed step says fit into ``seconds``, on every rank; a
per-layer metric is combined over the ranks by its reader's ``OVER_RANKS``
(``mean`` unless it says ``min``); rank 0 checks the global batch against
the reference.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field

import torch
from torch.autograd.profiler import record_function

import bounds
import check
import inputs
import program
import tracing
from manifest import Manifest, load
from reference import models as ref_models
from reference import step as ref_step

__all__ = ["Cell", "Run", "TRAFFIC_KEYS", "forward_flops", "run_cell"]

# keys of every traffic file; a driver adds its own (``TRAFFIC_KEYS``)
TRAFFIC_KEYS = {"driver", "pool", "trace_steps", "spectrum", "what", "assumed"}


@dataclass
class Run:
    """What one run of a cell leaves: the result's parts and, for the
    calibration, the cell it ran (its rows, draws and reference)."""

    workload: str
    kind: str
    cfg: dict
    metrics: dict = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    breakdown: dict | None = None
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)
    correct: bool = False
    program_out: dict = field(default_factory=dict)
    reference_out: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)
    cell: "Cell | None" = None

    def result(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def forward_flops(model_cfg: dict) -> float:
    """FLOPs of one image's forward through the reference model, counted by
    ``FlopCounterMode`` on the meta device (2 per multiply-add of a product;
    no elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_models.build(model_cfg, "meta")
    g = model_cfg["dct_blocks"]
    y = torch.zeros((1, 1, g, g, 8, 8), device="meta")
    c = torch.zeros((1, 2, g // 2, g // 2, 8, 8), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(y, c)
    return float(counter.get_total_flops())


class _Marks:
    """Seconds of each part of set-up, each from the mark before it."""

    def __init__(self, parts: dict, t_start: float):
        self.parts, self.last = parts, t_start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def _no_span(name: str):
    return contextlib.nullcontext()


def _group() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Cell:
    """What a driver works with in one run: the configuration, the traffic,
    the wire module, the seed, the rows (the global pool and this rank's
    slice of it), the Trainer, the process group, and the span opener (a
    no-op outside a traced window)."""

    def __init__(self, run: Run, cfg: dict, traffic: dict, wire, seed: int, device,
                 batch: int, k: int):
        self.run, self.cfg, self.traffic, self.wire = run, cfg, traffic, wire
        self.seed, self.device, self.batch, self.k = seed, device, batch, k
        self.grid = cfg["model"]["dct_blocks"]
        self.world, self.rank = _group()
        self.local_batch = batch // self.world
        self.mine = slice(self.rank * self.local_batch, (self.rank + 1) * self.local_batch)
        self.pool: list = []
        self.local_pool: list = []
        self.trainer = None
        self.span = _no_span
        self.mark = lambda name: None  # set-up's clock (``_Marks``)
        self.state: dict = {}  # the driver's own

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def over_ranks(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` summed ("sum") or maximised ("max") over the ranks."""
        if self.world > 1:
            ops = {"sum": torch.distributed.ReduceOp.SUM,
                   "max": torch.distributed.ReduceOp.MAX}
            torch.distributed.all_reduce(t, op=ops[op])
        return t

    def mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        return self.over_ranks(t.detach().clone(), "sum") / self.world

    def upload(self, i: int):
        """Upload pool batch ``i`` (cycled) of this rank through the Trainer."""
        with self.span("pb.upload"):
            rows = self.local_pool[i % len(self.local_pool)]
            return self.trainer.upload(self.wire.loader_batch(rows))

    def decode(self, rows: torch.Tensor):
        """The wire's meaning of global rows, for the reference."""
        return self.wire.decode(rows, self.grid, self.k)

    def rows_on_device(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[i % len(self.pool)]).to(self.device)

    def reference_model(self, precision: str | None = None):
        """The plain reference model with the seed's weights, in
        ``precision`` (the control's) or float32."""
        m = self.cfg["model"]
        model = ref_models.build(m, self.device)
        if precision is not None:
            ref_models.set_precision(model, ref_models.Precision(precision))
        params = dict(model.named_parameters())
        with torch.no_grad():
            shapes = ref_models.build(m, "meta")
            for name, w in inputs.make_weights(self.seed, shapes, self.device).items():
                params[name].copy_(w)
        return model


def _validate(cfg: dict, traffic: dict, driver) -> None:
    """Refuse what no part of the harness reads."""
    unknown = sorted(set(traffic) - TRAFFIC_KEYS - set(driver.TRAFFIC_KEYS))
    if unknown:
        raise ValueError(f"the driver {traffic['driver']!r} takes no traffic keys {unknown}")
    ref_models.check_model(cfg["model"])
    ref_step.check_train(cfg["train"])


def _read_metrics(c: Cell, man: Manifest, workload: str, ctx) -> dict:
    """Every per-layer metric the cell lists, combined over the ranks; raises
    where one reads nothing."""
    listed = man.per_layer(workload)
    readers = [load("metrics", m["name"]) for m in listed]
    values = [r.read(ctx) for r in readers]
    if c.world > 1:
        mine = torch.tensor([math.nan if v is None else float(v) for v in values],
                            dtype=torch.float64, device=c.device)
        every = [torch.empty_like(mine) for _ in range(c.world)]
        torch.distributed.all_gather(every, mine)
        table = torch.stack(every).cpu()
        values = []
        for j, r in enumerate(readers):
            col = table[:, j]
            rule = getattr(r, "OVER_RANKS", "mean")
            values.append(None if bool(torch.isnan(col).any()) else
                          float(col.min() if rule == "min" else col.mean()))
    missing = [m["name"] for m, v in zip(listed, values) if v is None]
    if missing:
        raise RuntimeError(f"{workload}: the per-layer metrics {missing} read nothing: their "
                           "spans or counters caught no device time")
    return {m["name"]: {"value": v, "unit": m["unit"]} for m, v in zip(listed, values)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", chips: int = 1, manifest: Manifest | None = None,
             tamper=None) -> Run:
    """Run ``workload`` once; ``t_start`` is the process's start on
    ``time.perf_counter``'s clock; ``tamper(trainer)`` breaks the program
    on purpose (the tests' faults)."""
    man = manifest or Manifest()
    wl = man.workload(workload)
    cfg = man.config(wl["config"])
    traffic = man.traffic(wl["traffic"])
    driver = man.driver(traffic["driver"])
    wire = man.wire(cfg["wire"])
    _validate(cfg, traffic, driver)
    m = cfg["model"]
    batch = driver.batch(cfg, traffic)
    run = Run(workload, driver.KIND, cfg)
    c = Cell(run, cfg, traffic, wire, seed, device, batch, cfg["wire"][driver.WIRE_K])
    run.cell = c
    if traffic.get("ranks", 1) != c.world or (c.world > 1 and not driver.SHARDS):
        raise RuntimeError(f"{workload} ({traffic['driver']}) runs over "
                           f"{traffic.get('ranks', 1)} ranks; the process group has {c.world}")
    mark = _Marks(run.setup_parts, t_start)
    mark("imports")
    if c.cuda:
        program.build_kernels()
    mark("kernel build")
    c.pool = inputs.make_rows(seed, traffic["pool"], batch, c.grid, c.k, m["classes"], device,
                              traffic["spectrum"], wire.encode)
    c.local_pool = [rows[c.mine] for rows in c.pool]
    mark("rows")
    shapes = ref_models.build(m, "meta")
    c.trainer = program.make_trainer(cfg, device, inputs.make_weights(seed, shapes, device),
                                     wire.trainer_options(cfg["wire"]))
    mark("trainer")
    if tamper is not None:
        tamper(c.trainer)

    # ---- set-up: the driver's own steps through the window's call
    c.mark = mark
    first = driver.prepare(c)
    c.sync()
    mark("warm-up")
    if c.cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # ---- the window
    outputs, n = [], 0
    if trace:
        c.span = record_function
        program.install_spans(c.trainer)
        steps = traffic["trace_steps"]

        def block():
            nonlocal n
            with c.span("pb.window"):
                for _ in range(steps):
                    with c.span("pb.step"):
                        outputs.append(driver.step(c, first + n))
                    n += 1
                c.sync()

        with driver.window():
            tr = tracing.record(block)
    elif c.world > 1:
        # every rank runs the same number of steps: as many as rank 0's
        # timed step says fit into ``seconds``
        with driver.window():
            t0 = time.perf_counter()
            driver.step(c, first)
            c.sync()
            count = torch.tensor([max(1, round(seconds / (time.perf_counter() - t0)))],
                                 device=device)
            torch.distributed.broadcast(count, 0)
            first += 1
            torch.distributed.barrier()
            t0 = time.perf_counter()
            for _ in range(int(count)):
                outputs.append(driver.step(c, first + n))
                n += 1
            c.sync()
            torch.distributed.barrier()
            window_s = time.perf_counter() - t0
    else:
        with driver.window():
            t0 = time.perf_counter()
            while True:
                outputs.append(driver.step(c, first + n))
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            c.sync()
            window_s = time.perf_counter() - t0
    run.attempted = n
    peak = torch.cuda.max_memory_allocated() if c.cuda else 0
    if c.world > 1:
        peak = int(c.over_ranks(torch.tensor([float(peak)], device=device), "max"))

    # ---- what the window produced, read once it has closed
    driver.collect(c, outputs, first)
    e2e = {"peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    if not trace:
        e2e[f"{driver.KIND}_imgs_per_s"] = n * batch / window_s
    run.device = {"platform": "gpu" if c.cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if c.cuda else "cpu",
                  "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        times = torch.tensor([tr.busy_s, tr.window_s], dtype=torch.float64, device=device)
        busy_s, trace_s = (float(v) for v in c.over_ranks(times, "sum") / c.world)
        run.device.update(busy_s=busy_s, window_s=trace_s)
        run.breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        n_pool = len(c.local_pool)
        ctx = ReaderContext(kind=driver.KIND, cfg=cfg, batch=c.local_batch, steps=n, trace=tr,
                            read_bytes=[wire.read_bytes(c.local_pool[(first + i) % n_pool],
                                                        c.grid, c.k) for i in range(n)],
                            flops_per_image=forward_flops(m), chips=c.world)
        run.metrics = _read_metrics(c, man, workload, ctx)
    else:
        for metric in man.end_to_end(workload):
            run.metrics[metric["name"]] = {"value": e2e[metric["name"]], "unit": metric["unit"]}
    c.trainer = None
    del outputs
    gc.collect()
    if c.cuda:
        torch.cuda.empty_cache()

    if c.rank != 0:
        return run  # rank 0 checks the global batch
    # ---- the reference, once the program's state is freed
    run.checks = driver.check(c)
    run.checks["failed_steps"] = {"value": run.failed, "limit": 0}
    run.correct = check.passed(run.checks)
    return run


@dataclass
class ReaderContext:
    """What a per-layer metric's reader reads: the cell's kind (the driver's
    ``KIND``, ``train`` or ``eval``), its configuration, the batch of this
    rank, the traced steps, this rank's trace, each traced batch's wire
    bytes, the forward FLOPs of one image, and the chips of the cell."""

    kind: str
    cfg: dict
    batch: int
    steps: int
    trace: tracing.Trace
    read_bytes: list
    flops_per_image: float
    chips: int = 1

    @property
    def images(self) -> int:
        return self.steps * self.batch

    @property
    def peak(self) -> float:
        return bounds.peak_flop_per_s(self.cfg["compute_dtype"])

    def device_s(self, *spans: str) -> float:
        return sum(self.trace.span_device_s.get(s, 0.0) for s in spans)

    def share(self, bound_s: float, *spans: str):
        """100 x ``bound_s`` over the device time of ``spans``; None where
        they ran nothing on the device."""
        dev = self.device_s(*spans)
        return None if dev <= 0 or math.isnan(dev) else 100.0 * bound_s / dev
