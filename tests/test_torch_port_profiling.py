"""The port's model summary and profiling (``rgbnomore_tpu_torch/utils/
summary.py``, ``utils/profiling.py``) against the JAX package's, on the
CPU.

- ``model_summary``'s total equals flax's ``tabulate`` total and the
  model's own parameter count; the root row's output is ``float32[2,1000]``
  at the presets' 1,000 classes.
- ``model_flops`` of a small ViT is the exact sum of its products; against
  XLA's count (which also counts elementwise work) the port's full-width
  ViT-Ti, ViT-S/16 and SwinV2-T fall within [0.90, 1.00].
- ``Timer``, ``Timer.sync`` and ``trace`` work on the CPU.
"""

import re

import jax
import pytest
import torch

from torch_port_support import settle_inspect_module_walk, tiny_swin_cfg, torch_threads
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import example_inputs as jax_example_inputs
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu.utils.profiling import model_flops as xla_model_flops
from rgbnomore_tpu.utils.summary import model_summary as jax_model_summary
from rgbnomore_tpu_torch.train.config import build_model, example_inputs, generate_config
from rgbnomore_tpu_torch.utils.profiling import Timer, compiled_cost, model_flops, trace
from rgbnomore_tpu_torch.utils.summary import model_summary


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    settle_inspect_module_walk()  # the counter's first use imports torch._dynamo
    with torch_threads(2):
        yield


def _small_vit(gen, ver=1, subblock=True, classes=5):
    cfg = gen("vitti", "dct", modelver=ver, subblock=subblock)
    cfg.model.depth, cfg.model.embed_size = 2, 48
    cfg.model.heads, cfg.model.head_size = 2, 24
    cfg.model.classes, cfg.model.dct_blocks = classes, 8
    return cfg


SUMMARY_CASES = {
    "vit_ver1": lambda gen: _small_vit(gen, 1, classes=1000),
    "vit_ver2": lambda gen: _small_vit(gen, 2, classes=1000),
    "vit_ver3": lambda gen: _small_vit(gen, 3, classes=1000),
    "swin": lambda gen: tiny_swin_cfg(gen, classes=1000),
}


def _total(table: str) -> int:
    return int(re.search(r"Total Parameters: ([\d,]+)", table).group(1).replace(",", ""))


@pytest.mark.parametrize("case", list(SUMMARY_CASES))
def test_summary_total_matches_flax(case):
    jax_cfg = SUMMARY_CASES[case](jax_generate_config)
    want = _total(jax_model_summary(jax_build_model(jax_cfg), jax_cfg))
    cfg = SUMMARY_CASES[case](generate_config)
    model = build_model(cfg, device="cpu")
    table = model_summary(model, cfg)
    assert _total(table) == want == sum(p.numel() for p in model.parameters())
    root = table.splitlines()[3]  # title, header, rule, then the model's own row
    assert root.split("|")[1].strip() == type(model).__name__
    assert root.split("|")[2].strip() == "float32[2,1000]"
    assert "Total" in table.splitlines()[-2]


def test_summary_rows_sum_to_the_total():
    cfg = _small_vit(generate_config, 2)
    model = build_model(cfg, device="cpu")
    table = model_summary(model, cfg, batch=3, depth=1)
    rows = [r.split("|") for r in table.splitlines()[3:-3]]
    assert [r[0].strip() for r in rows] == [""] + [n for n, _ in model.named_children()]
    assert sum(int(r[3].replace(",", "") or 0) for r in rows) == _total(table)
    assert "float32[3,5]" in rows[0][2]


def test_model_flops_is_the_sum_of_products():
    """ViT embed_type 1 without sub-blocks (no basis change in its
    embedding): per image the patch projection, per block qkv, QKᵀ and PV,
    the output projection and the MLP, then the head's two Linears on the
    pooled token; twice that at batch 2."""
    cfg = _small_vit(generate_config, 1, subblock=False)
    e, n, depth, classes = 48, 16, 2, 5
    feats = 16 * 16 + 2 * 8 * 8  # a 16-px patch's luma and chroma coefficients
    per_block = 2 * n * e * 3 * e + 4 * n * n * e + 2 * n * e * e + 2 * 2 * n * e * 4 * e
    want = 2 * n * feats * e + depth * per_block + 2 * e * e + 2 * e * classes
    model = build_model(cfg, device="cpu").train()
    for batch in (1, 2):
        assert model_flops(model, *example_inputs(cfg, batch, device="cpu")) == batch * want
    assert model.training  # the mode is restored


def test_compiled_cost_counts_a_product():
    a = torch.ones(64, 32)
    assert compiled_cost(lambda x, y: x @ y, a, a.T) == {"flops": 2.0 * 64 * 64 * 32}


XLA_CASES = {
    "vitti": lambda gen: gen("vitti", "dct", modelver=1),
    "vits": lambda gen: gen("vits", "dct", modelver=2),
    "swinv2": lambda gen: gen("swinv2", "dct"),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_model_flops_against_xla(case):
    """The full-width models at batch 1: XLA's count of the JAX forward also
    holds the elementwise work (softmax, norms, GELU), so the port's
    products are a little less."""
    jax_cfg = XLA_CASES[case](jax_generate_config)
    jmodel = jax_build_model(jax_cfg)
    xs = jax_example_inputs(jax_cfg, batch=1)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *xs))
    params = jax.tree.map(lambda s: jax.numpy.zeros(s.shape, s.dtype), shapes)
    xla = xla_model_flops(jmodel, params, *xs)
    cfg = XLA_CASES[case](generate_config)
    port = model_flops(build_model(cfg, device="cpu"), *example_inputs(cfg, 1, device="cpu"))
    assert 0.90 <= port / xla <= 1.00, (port, xla)


def test_timer_and_trace(tmp_path):
    a = torch.randn(64, 64)
    with Timer() as t:
        out = Timer.sync({"y": [a @ a]})
    assert t.elapsed > 0 and out["y"][0].shape == (64, 64)
    with trace(str(tmp_path)):
        a @ a
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()
