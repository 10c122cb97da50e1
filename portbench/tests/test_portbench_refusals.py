"""What the harness refuses instead of leaving out: a key of a
configuration, a traffic mix or a wire that no part of it reads, a value
the reference does not model, a span gone from the port, and a per-layer
metric that reads nothing."""

import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import program
from cell import ReaderContext, _read_metrics, run_cell
from manifest import Manifest, load
from reference import models as ref_models
from reference import step as ref_step
from tracing import Trace

TINY = Path(__file__).resolve().parent / "tiny"


def _edited(tmp_path, name: str, edit) -> Manifest:
    """The tiny manifest with ``edit(data)`` applied to its file ``name``."""
    shutil.copytree(TINY, tmp_path / "tiny")
    path = tmp_path / "tiny" / name
    data = json.loads(path.read_text())
    edit(data)
    path.write_text(json.dumps(data))
    return Manifest(tmp_path / "tiny" / "bench.json", tmp_path / "tiny")


def _run(man, workload="vits16-train"):
    return run_cell(workload, 2**31 + 7, 0.01, False, t_start=time.perf_counter(),
                    device="cpu", manifest=man)


def test_an_unknown_configuration_key_is_refused(tmp_path):
    man = _edited(tmp_path, "tiny-vit.json", lambda d: d.update(packed_k=16))
    with pytest.raises(ValueError, match="packed_k"):
        man.config("tiny-vit")


@pytest.mark.parametrize("edit, match", [
    (lambda d: d["model"].update(ape=True), "keys"),
    (lambda d: d["model"].update(domain="RGB"), "domain"),
    (lambda d: d["model"].update(version=3), "version"),
])
def test_a_model_the_reference_does_not_model_is_refused(edit, match):
    model = json.loads((TINY / "tiny-vit.json").read_text())
    edit(model)
    with pytest.raises(ValueError, match=match):
        ref_models.check_model(model["model"])


def test_swinv2_without_its_modeled_values_is_refused():
    model = json.loads((TINY / "tiny-swin.json").read_text())["model"]
    ref_models.check_model(model)
    with pytest.raises(ValueError, match="ape"):
        ref_models.check_model({**model, "ape": True})


@pytest.mark.parametrize("edit, match", [
    (lambda t: t.update(drop=0.1), "dropout"),
    (lambda t: t.update(augmax=30), "bins"),
    (lambda t: t.update(label_smoothing=0.1), "label_smoothing"),
])
def test_a_train_section_the_reference_does_not_model_is_refused(edit, match):
    t = dict(json.loads((TINY / "tiny-vit.json").read_text())["train"])
    ref_step.check_train(t)
    edit(t)
    with pytest.raises(ValueError, match=match):
        ref_step.check_train(t)


def test_a_wire_with_no_module_is_refused(tmp_path):
    man = _edited(tmp_path, "tiny-vit.json", lambda d: d["wire"].update(format="packed"))
    with pytest.raises(KeyError, match="cropped.packed"):
        _run(man)


def test_a_wire_key_the_module_does_not_take_is_refused():
    wire = Manifest.wire({"transfer": "cropped", "format": "mask16"})
    with pytest.raises(ValueError, match="keys"):
        wire.trainer_options({"transfer": "cropped", "format": "mask16", "train_k": 16,
                              "eval_k": 48, "requant": True})


def test_an_unknown_traffic_key_is_refused(tmp_path):
    man = _edited(tmp_path, "tiny-train.json", lambda d: d.update(batch=4))
    with pytest.raises(ValueError, match="batch"):
        _run(man)


def test_a_traffic_with_no_driver_module_is_refused(tmp_path):
    man = _edited(tmp_path, "tiny-train.json", lambda d: d.update(driver="loader_step"))
    with pytest.raises(KeyError, match="loader_step"):
        _run(man)


def test_a_key_the_ports_config_lacks_is_refused():
    cfg = json.loads((TINY / "tiny-vit.json").read_text())
    cfg["model"]["window_shape"] = 7
    with pytest.raises(ValueError, match="window_shape"):
        program._port_config(cfg)


def test_spans_refuse_a_model_without_attention():
    trainer = SimpleNamespace(model=torch.nn.Linear(2, 2), train_pipe=print, eval_pipe=print)
    with pytest.raises(RuntimeError, match="attention"):
        program.install_spans(trainer)


def test_a_listed_metric_that_reads_nothing_fails_the_run(tiny_manifest):
    ctx = ReaderContext(kind="train", cfg=tiny_manifest.config("tiny-vit"), batch=4, steps=1,
                        trace=Trace(window_s=1.0, busy_s=0.5), read_bytes=[1000],
                        flops_per_image=1e9)
    c = SimpleNamespace(world=1)
    with pytest.raises(RuntimeError, match="vit_attn_roofline.train"):
        _read_metrics(c, tiny_manifest, "vits16-train", ctx)
    ctx.trace.span_device_s = {"pb.attn.fwd": 1e-3, "pb.attn.bwd": 2e-3, "pb.pipeline": 1e-4}
    read = _read_metrics(c, tiny_manifest, "vits16-train", ctx)
    assert set(read) == {m["name"] for m in tiny_manifest.per_layer("vits16-train")}


def test_the_exchange_is_read_on_the_rank_that_waits_least():
    assert load("metrics", "nccl_ms_per_step.train").OVER_RANKS == "min"
    assert not hasattr(load("metrics", "device_idle_pct.train"), "OVER_RANKS")


def _rank_metrics(rank: int, world: int, port: int, out) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        man = Manifest()
        spans = {"pb.attn.fwd": 1e-3, "pb.attn.bwd": 2e-3, "pb.pipeline": 1e-4,
                 "pb.exchange": (rank + 1) * 1e-3}
        ctx = ReaderContext(kind="train", cfg=man.config("vits16-dct-e2-fp32"), batch=256,
                            steps=1, trace=Trace(window_s=1.0, busy_s=0.9 - 0.1 * rank,
                                                 span_device_s=spans),
                            read_bytes=[10**8], flops_per_image=9e9, chips=world)
        c = SimpleNamespace(world=world, device="cpu")
        read = _read_metrics(c, man, "vits16-train-dp4", ctx)
        out.put((rank, {k: v["value"] for k, v in read.items()}))
    finally:
        dist.destroy_process_group()


def test_metrics_combine_over_ranks_by_their_readers_rule():
    import multiprocessing as mp

    from ranks import _free_port

    ctx = mp.get_context("spawn")
    out, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_rank_metrics, args=(r, 4, port, out)) for r in range(4)]
    for p in procs:
        p.start()
    got = dict(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive()
    assert all(v == got[0] for v in got.values())
    assert got[0]["nccl_ms_per_step.train"] == pytest.approx(1.0)  # the least rank's
    assert got[0]["device_idle_pct.train"] == pytest.approx(100 * (1 - 0.75))  # the mean
