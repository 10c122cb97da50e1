"""Reading a profiler trace: the window, the device's busy time, device time
by span (launches matched on their host thread), the breakdown, and the
readers on it."""

import pytest

from cell import ReaderContext
from manifest import Manifest
from tracing import parse

MAN = Manifest()


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = {"traceEvents": [
    _x("user_annotation", "pb.window", 0, 1000),
    _x("user_annotation", "pb.step", 10, 900),
    _x("user_annotation", "pb.pipeline", 20, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),
    _x("user_annotation", "pb.attn.fwd", 60, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 65, 2, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 90, 2, corr=3),
    # the backward on its own thread
    _x("user_annotation", "pb.attn.bwd", 100, 50, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 2, tid=2, corr=4),
    _x("user_annotation", "pb.optimizer", 700, 100),
    _x("kernel", "wire_reader", 30, 100, tid=7, corr=1),
    _x("kernel", "attn_fwd", 130, 50, tid=7, corr=2),
    _x("kernel", "gemm", 180, 300, tid=7, corr=3),
    _x("kernel", "attn_bwd", 480, 120, tid=7, corr=4),
    _x("gpu_memcpy", "Memcpy HtoD", 900, 50, tid=8),
    _x("kernel", "outside", 1200, 10, tid=7, corr=9),
]}


def test_parse_window_busy_spans_and_breakdown():
    tr = parse(TRACE)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx((570 + 50) * 1e-6)  # 30..600 and the copy
    assert tr.span_device_s["pb.pipeline"] == pytest.approx(100e-6)
    assert tr.span_device_s["pb.attn.fwd"] == pytest.approx(50e-6)
    assert tr.span_device_s["pb.attn.bwd"] == pytest.approx(120e-6)
    assert tr.span_device_s["pb.step"] == pytest.approx(450e-6)
    assert "pb.optimizer" not in tr.span_device_s
    assert tr.device_ops[0] == ["gemm", pytest.approx(300e-6)]
    assert [g[0] for g in tr.idle_gaps][:2] == ["pb.optimizer", "pb.window"]
    assert tr.idle_gaps[0][1] == pytest.approx(300e-6)


def _ctx(kind, cfg, steps=1, batch=4):
    return ReaderContext(kind=kind, cfg=cfg, batch=batch, steps=steps, trace=parse(TRACE),
                         read_bytes=[1000] * steps, flops_per_image=1e9)


def test_readers_read_their_cells_only():
    vit = MAN.config("vits16-dct-e2-fp32")
    swin = MAN.config("swinv2t-dct-bf16")
    train, ev = _ctx("train", vit), _ctx("eval", vit)
    read = MAN.reader
    assert read("device_idle_pct.train")(train) == pytest.approx(100 * (1 - 620 / 1000))
    assert read("device_idle_pct.train")(ev) is None
    assert read("step_mfu.train")(train) == pytest.approx(100 * 3e9 * 4 / 1e-3 / 495e12)
    assert read("step_mfu.eval")(ev) == pytest.approx(100 * 1e9 * 4 / 1e-3 / 495e12)
    assert read("win_attn_roofline.train")(train) is None
    assert read("vit_attn_roofline.train")(_ctx("train", swin)) is None
    assert read("vit_attn_roofline.train")(train) > 0
    assert read("augpipe_roofline.eval")(ev) > 0


def test_a_span_with_no_device_time_reads_nothing():
    ctx = _ctx("train", MAN.config("vits16-dct-e2-fp32"))
    ctx.trace.span_device_s = {}
    assert MAN.reader("vit_attn_roofline.train")(ctx) is None
    assert MAN.reader("augpipe_roofline.train")(ctx) is None
