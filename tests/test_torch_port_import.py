"""The port's importer of the reference's ``.pth`` files
(``rgbnomore_tpu_torch/train/torch_import.py``) against the JAX package's
(``rgbnomore_tpu/train/torch_import.py``) on the CPU.

There are no released weights here, so each test writes a state dict under
the reference's module names (``models/plainvit.py``, ``models/swinv2.py``)
from a numpy seed: every tensor of the port's model under its reference
name, the ViT's fused qkv rows random and so not symmetric under the
reference's (h, d, qkv) interleave (``torch_port_support.reference_state_dict``,
whose name maps the card's import phase uses too).  Sizes as ``test_torch_port_embeddings
.py`` cuts them: depth 2, emb 48, 2 heads of 24, an 8-block grid, 5
classes; SwinV2 at ``tiny_swin_cfg``.

- The port's import equals ``flax_to_state_dict`` of the JAX import bit for
  bit, key for key, and loads with ``strict=True``: the five DCT
  embeddings of ``tests/test_torch_import.py``, the RGB ViT, and SwinV2 in
  the DCT and RGB domains.
- The logits of the JAX model on the JAX import and of the port's on its
  own agree at the JAX test's atol 2e-4, rtol 1e-3.
- Loading the qkv rows without the permutation changes the logits.
- The epoch-checkpoint dict with ``module.``-prefixed names, and the bare
  state dict, load through ``load_torch_checkpoint`` to the same tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import (
    SWIN_REFERENCE_NAMES,
    VIT_EMBED_REFERENCE_NAMES,
    VIT_REFERENCE_NAMES,
    reference_state_dict,
    tiny_swin_cfg,
    torch_threads,
)
from rgbnomore_tpu.train import torch_import as jax_import
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.train import torch_import
from rgbnomore_tpu_torch.train.config import build_model, generate_config

TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_torch_import.py


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


def _vit_cfg(gen, ver, subblock, domain):
    cfg = gen("vitti", domain, modelver=ver, subblock=subblock)
    cfg.model.depth, cfg.model.embed_size = 2, 48
    cfg.model.heads, cfg.model.head_size = 2, 24
    cfg.model.classes, cfg.model.dct_blocks, cfg.model.input_size = 5, 8, 64
    return cfg


def _swin_cfg(gen, domain):
    cfg = tiny_swin_cfg(gen)
    if domain == "rgb":  # the same model on 64 px: a stride-4 stem to 16x16 tokens
        rgb = gen("swinv2", "rgb")
        cfg.model.domain, cfg.model.patch_size = rgb.model.domain, rgb.model.patch_size
    return cfg


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


VIT_CASES = [(1, True), (1, False), (2, True), (2, False), (3, True)]


def _vit_case(ver, subblock, domain, rng):
    cfg = _vit_cfg(generate_config, ver, subblock, domain)
    model = build_model(cfg, device="cpu").eval()
    rules = VIT_REFERENCE_NAMES + VIT_EMBED_REFERENCE_NAMES.get((ver, subblock), [])
    ref = reference_state_dict(model, rules, rng, 0.1)
    kw = dict(num_heads=2, head_size=24, depth=2, ver=ver, use_subblock=subblock,
              pixel_space=cfg.model.domain)
    return cfg, model, ref, kw


def _inputs(cfg, rng, batch=2):
    if cfg.model.domain == "RGB":
        return (rng.standard_normal((batch, 3, 64, 64)).astype(np.float32),)
    return (rng.standard_normal((batch, 1, 8, 8, 8, 8)).astype(np.float32),
            rng.standard_normal((batch, 2, 4, 4, 8, 8)).astype(np.float32))


def _logits(jax_cfg, jax_params, model, state_dict, inputs):
    want = np.asarray(jax.jit(jax_build_model(jax_cfg).apply)(
        {"params": jax_params}, *map(jnp.asarray, inputs)))
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, inputs)).numpy()
    return got, want


@pytest.mark.parametrize("ver,subblock,domain", [(v, s, "dct") for v, s in VIT_CASES]
                         + [(1, True, "rgb")],
                         ids=[f"ver{v}_{'subblock' if s else 'no_subblock'}"
                              for v, s in VIT_CASES] + ["rgb"])
def test_vit_import_matches_jax(ver, subblock, domain):
    rng = np.random.default_rng(10 + ver)
    cfg, model, ref, kw = _vit_case(ver, subblock, domain, rng)
    jax_params = jax_import.import_vit_state_dict(ref, **kw)
    got = torch_import.import_vit_state_dict(ref, **kw)
    _assert_same(got, flax_to_state_dict(jax_params))
    logits, want = _logits(_vit_cfg(jax_generate_config, ver, subblock, domain), jax_params,
                           model, got, _inputs(cfg, rng))
    assert logits.shape == (2, 5)
    np.testing.assert_allclose(logits, want, **TOL)


@pytest.mark.parametrize("domain", ["dct", "rgb"])
def test_swin_import_matches_jax(domain):
    rng = np.random.default_rng(20)
    cfg = _swin_cfg(generate_config, domain)
    model = build_model(cfg, device="cpu").eval()
    ref = reference_state_dict(model, SWIN_REFERENCE_NAMES, rng, 0.1)
    kw = dict(depths=tuple(cfg.model.depth), pixel_space=cfg.model.domain)
    jax_params = jax_import.import_swin_state_dict(ref, **kw)
    got = torch_import.import_swin_state_dict(ref, **kw)
    _assert_same(got, flax_to_state_dict(jax_params))
    logits, want = _logits(_swin_cfg(jax_generate_config, domain), jax_params, model, got,
                           _inputs(cfg, rng))
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(logits, want, **TOL)


def test_qkv_permutation_moves_the_logits():
    """The reference's rows loaded as they are (no (h, d, qkv) -> (qkv, h,
    d) permutation) give other logits: the permutation is not a no-op on
    these rows."""
    rng = np.random.default_rng(30)
    cfg, model, ref, kw = _vit_case(1, True, "dct", rng)
    imported = torch_import.import_vit_state_dict(ref, **kw)
    unpermuted = dict(imported)
    for i in range(2):
        for leaf in ("weight", "bias"):
            unpermuted[f"encoder_{i}.mha.qkv.{leaf}"] = ref[f"encoder.{i}.0.fn.eb_mha.qkv.{leaf}"]
    assert not torch.equal(unpermuted["encoder_0.mha.qkv.weight"],
                           imported["encoder_0.mha.qkv.weight"])
    inputs = tuple(map(torch.from_numpy, _inputs(cfg, rng)))
    outs = []
    for sd in (imported, unpermuted):
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs.append(model(*inputs).numpy())
    assert np.abs(outs[0] - outs[1]).max() > 100 * TOL["atol"]


def test_checkpoint_formats_load(tmp_path):
    """A bare ``state_dict`` file and the epoch-checkpoint dict with DDP's
    ``module.`` prefix load to the same tensors as the importer on the
    dict; SwinV2's epoch checkpoint, read with ``torch.load``, imports
    through ``import_swin_state_dict`` as its bare dict does."""
    rng = np.random.default_rng(40)
    _, _, ref, kw = _vit_case(2, True, "dct", rng)
    want = torch_import.import_vit_state_dict(ref, **kw)
    torch.save(ref, tmp_path / "bare.pth")
    torch.save({"epoch": 3, "model_state_dict": {f"module.{k}": v for k, v in ref.items()},
                "loss": 1.0}, tmp_path / "epoch.ckpt")
    for name in ("bare.pth", "epoch.ckpt"):
        _assert_same(torch_import.load_torch_checkpoint(str(tmp_path / name), **kw), want)

    cfg = _swin_cfg(generate_config, "dct")
    swin = reference_state_dict(build_model(cfg, device="cpu"), SWIN_REFERENCE_NAMES, rng, 0.1)
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in swin.items()}},
               tmp_path / "swin.ckpt")
    skw = dict(depths=tuple(cfg.model.depth))
    blob = torch.load(tmp_path / "swin.ckpt", weights_only=True)["model_state_dict"]
    _assert_same(torch_import.import_swin_state_dict(blob, **skw),
                 torch_import.import_swin_state_dict(swin, **skw))
