"""The SwinV2-B/w16 configuration and its cell: the manifest loads them,
the reference models them, the window attention calls' shapes are SwinV2-B's
at window 16, and the window attention time reader reads SwinV2 cells
only."""

from types import SimpleNamespace

import pytest

import bounds
from manifest import Manifest, load
from reference import models as ref_models

MAN = Manifest()
CELL = "swinv2b-w16-train"


def test_cell_and_configuration_load():
    wl = MAN.workload(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("swinv2b-w16-dct-bf16", "train-pool4", 1)
    cfg = MAN.config(wl["config"])
    m = cfg["model"]
    assert ref_models.check_model(m) == "swinv2"
    assert (m["embed_size"], m["depth"], m["heads"]) == (128, [2, 2, 18, 2], [4, 8, 16, 32])
    assert (m["window_size"], m["drop_path"], m["dct_blocks"]) == (16, 0.5, 32)
    assert cfg["preset"] == "swinv2b" and cfg["reduced"] == [] and cfg["control"] == "fp8"
    assert cfg["train"]["batch_size"] * cfg["train"]["steps_per_epoch"] <= 1_281_167
    assert set(cfg["limits"]) == {"train"}
    names = {x["name"] for x in MAN.per_layer(CELL)}
    assert names == {"step_mfu.train", "win_attn_roofline.train", "augpipe_roofline.train",
                     "device_idle_pct.train", "win_attn_ms_per_step.train"}
    assert {x["name"] for x in MAN.end_to_end(CELL)} == {"train_imgs_per_s", "peak_mem_gib",
                                                        "setup_s"}


def test_window_attention_calls_of_swinv2b_w16():
    """22 calls on 256-token windows (stages 1-3), 2 on stage 4's one
    64-token window; the shifted blocks of stages 1 and 2 carry 16 and 4
    patterns, stage 3's one window a map is never shifted."""
    m = MAN.config("swinv2b-w16-dct-bf16")["model"]
    calls = bounds.window_attention_calls(m, 256)
    assert len(calls) == 24
    assert sum(c[2] == 256 for c in calls) == 22 and sum(c[2] == 64 for c in calls) == 2
    assert calls[:4] == [(4096, 4, 256, 32, 1), (4096, 4, 256, 32, 16),
                         (1024, 8, 256, 32, 1), (1024, 8, 256, 32, 4)]
    assert set(calls[4:22]) == {(256, 16, 256, 32, 1)}
    assert calls[22:] == [(256, 32, 64, 32, 1)] * 2
    big = sum(bounds.window_bound_s(*c, False) + bounds.window_bound_s(*c, True)
              for c in calls if c[2] == 256)
    every = sum(bounds.window_bound_s(*c, False) + bounds.window_bound_s(*c, True)
                for c in calls)
    assert 0.96 < big / every < 0.975  # 96.8% of the bound on the tiled kernels


@pytest.mark.parametrize("arch, kind, device_s, want", [
    ("swinv2", "train", 0.3, 100.0), ("swinv2", "train", 0.0, None),
    ("vits", "train", 0.3, None), ("swinv2", "eval", 0.3, None)])
def test_win_attn_ms_per_step_reads_swinv2_train_only(arch, kind, device_s, want):
    reader = load("metrics", "win_attn_ms_per_step.train")
    ctx = SimpleNamespace(kind=kind, cfg={"model": {"arch": arch}}, steps=3,
                          device_s=lambda *spans: device_s if spans == ("pb.attn.fwd",
                                                                        "pb.attn.bwd") else 0.0)
    got = reader.read(ctx)
    assert got == pytest.approx(want) if want is not None else got is None
