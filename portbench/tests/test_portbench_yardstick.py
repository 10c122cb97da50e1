"""The yardstick against the port's own sound pieces: the FLOP count, the
roofline arithmetic and the wire generators of ``chip_smoke.py``, the row
layout of the port's loader, and the whole-name module check."""

import numpy as np
import pytest
import torch

import bounds
import chip_smoke
import inputs
from cell import forward_flops
from manifest import Manifest
from reference import models as ref_models
from run import forbidden_modules

MAN = Manifest()
WIRE = Manifest.wire({"transfer": "cropped", "format": "mask16"})
SPECTRUM = MAN.traffic("train-pool4")["spectrum"]


@pytest.mark.parametrize("config, gflop", [("vits16-dct-e2-fp32", 9.125870),
                                           ("swinv2t-dct-bf16", 11.863652)])
def test_forward_flops_match_the_ports_count(config, gflop):
    m = MAN.config(config)["model"]
    assert forward_flops(m) / 1e9 == pytest.approx(gflop, abs=5e-7)


def test_flops_on_meta_equal_the_cpu_count():
    from torch.utils.flop_counter import FlopCounterMode

    m = MAN.config("vits16-dct-e2-fp32")["model"]
    model = ref_models.build(m, "cpu")
    y, c = torch.zeros((1, 1, 28, 28, 8, 8)), torch.zeros((1, 2, 14, 14, 8, 8))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(y, c)
    assert counter.get_total_flops() == forward_flops(m)


def _captured(monkeypatch, fn, *args):
    seen = []
    monkeypatch.setattr(chip_smoke, "product_bounds_ms", lambda f, b: seen.append((f, b)))
    fn(*args)
    return seen


def _bound(flop, nbytes):
    return max(flop / 495e12, nbytes / 3.35e12)


@pytest.mark.parametrize("shape", [(1024, 6, 196, 64), (256, 3, 196, 64)])
def test_attention_forward_bound_counts_chip_smokes_work(monkeypatch, shape):
    (flop, nbytes), = _captured(monkeypatch, chip_smoke.attention_bound_ms, *shape)
    assert bounds.attention_bound_s(*shape, "float32", False) == pytest.approx(
        _bound(flop, nbytes), rel=1e-12)


def test_attention_backward_bound_counts_chip_smokes_work():
    b, h, n, d = 1024, 6, 196, 64
    # kernel_attention_bwd: 10 N^2 D a head; q, k, v, out, dout, lse read, dq, dk, dv written
    want = _bound(10 * n * n * d * b * h, (8 * b * h * n * d + b * h * n) * 4)
    assert bounds.attention_bound_s(b, h, n, d, "float32", True) == pytest.approx(want)


def test_window_bounds_count_chip_smokes_work(monkeypatch):
    model = MAN.config("swinv2t-dct-bf16")["model"]
    calls = bounds.window_attention_calls(model, 128)
    assert len(calls) == 12
    for case in {c for c in calls}:
        fwd, bwd = _captured(monkeypatch, chip_smoke.window_bounds_ms, case)
        assert bounds.window_bound_s(*case, False) == pytest.approx(_bound(*fwd))
        assert bounds.window_bound_s(*case, True) == pytest.approx(_bound(*bwd))
    # the smoke test's blocks of one pass at the same batch
    want = sorted(c for c, k in chip_smoke.window_blocks(128) for _ in range(k))
    assert sorted(calls) == want


def test_vit_attention_calls():
    model = MAN.config("vits16-dct-e2-fp32")["model"]
    assert bounds.vit_attention_calls(model, 1024) == [(1024, 6, 196, 64)] * 12


@pytest.mark.parametrize("grid, k", [(28, 16), (28, 48), (32, 16), (32, 48)])
def test_wire_layout_is_the_ports(grid, k):
    from rgbnomore_tpu_torch.data.loader import packed_layout

    assert WIRE.layout(grid, k) == dict(packed_layout(grid, k, "mask16"))


def test_packing_matches_chip_smokes():
    rng = np.random.default_rng(5)
    y, _ = chip_smoke.synthetic_planes(rng, 3, 8)
    blocks = y.reshape(-1, 64)
    want = chip_smoke.pack_mask16(blocks, 16)
    got = WIRE._pack_blocks(torch.from_numpy(blocks), 16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


def test_rows_read_bytes_and_unpack():
    from rgbnomore_tpu_torch.augment.pipeline import split_packed_batch, unpack_cropped

    rows = inputs.make_rows(2**31 + 3, 1, 4, 28, 16, 1000, "cpu", SPECTRUM, WIRE.encode)[0]
    assert WIRE.read_bytes(rows, 28, 16) == chip_smoke.wire_read_bytes(rows, 28, 16, "mask16")
    packed = torch.from_numpy(rows)
    want = unpack_cropped(split_packed_batch(packed, 28, 16, "mask16"), "mask16")
    got = WIRE.decode(packed, 28, 16)[:2]
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    again = inputs.make_rows(2**31 + 3, 1, 4, 28, 16, 1000, "cpu", SPECTRUM, WIRE.encode)[0]
    np.testing.assert_array_equal(rows, again)


@pytest.mark.parametrize("names, found", [
    (["rgbnomore_tpu_torch", "rgbnomore_tpu_torch.ops.attention", "torch"], []),
    (["rgbnomore_tpu", "torch"], ["rgbnomore_tpu"]),
    (["rgbnomore_tpu.ops.pallas"], ["rgbnomore_tpu"]),
    (["jax", "jax._src", "jaxlib.xla_client", "flax.linen", "optax"],
     ["flax", "jax", "jaxlib", "optax"]),
    (["jaxtyping", "flaxen", "rgbnomore_tpux", "optaxy"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found
