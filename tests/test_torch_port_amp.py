"""Mixed precision in the port against the JAX package's, on the CPU.

The JAX package's AMP hands one compute dtype to every flax module
(``amp_compute_dtype``) and lets flax's promotion rules decide the rest;
the port follows them module by module (``models/layers.py``).  Here, in
bf16 and fp16, on seeded numpy inputs with parameters converted by
``convert.py``:

- ``amp_compute_dtype`` maps every name as the JAX one does, and raises
  ``ValueError`` where it does; the ``vitb``, ``vitl`` and ``swinv2``
  presets build a model that computes in bf16 with float32 parameters.
- The sincos table in bf16 and fp16 is bit-identical to JAX's, which builds
  it in the input's dtype.
- Linear and LayerNorm return flax's dtypes; the DCT embedding, the ViT
  encoder block (whose output, the residual stream, stays in the compute
  dtype), the head (float32 logits), SwinV2's window attention and block
  (whose output is float32) and the whole ViT and SwinV2 logits return the
  dtypes JAX returns, with values within the tolerances below, and each
  side's error against the float32 model on the same parameters within
  ERR_FACTOR of the other side's.

The port's window attention follows the JAX package's Pallas call site
(float32 q times the logit scale, k and v into the kernel, ``swinv2.py:
175-179``).  On the CPU JAX takes its einsum path instead, whose logits
and P are rounded to the compute dtype; its fused path is reached here by
``jax_fused_window_path`` (the Pallas kernel in interpret mode), and the
port's window attention matches it to a few roundings of the dtype.

Tolerances, as a share of the float32 output's largest magnitude (atol)
with an rtol of the same size: bf16 2^-5 and fp16 2^-8 for a module, bf16
2^-4 and fp16 2^-7 for whole-model logits (each side rounds every Linear,
GELU and residual add in the dtype, PyTorch once per fused op, XLA after
each; the port's bias add is fused into its product).
"""

import contextlib
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbnomore_tpu.ops.pallas.attention as pallas_attention
from rgbnomore_tpu.models import embeddings as jax_embeddings
from rgbnomore_tpu.models import swinv2 as jax_swinv2
from rgbnomore_tpu.models import vit as jax_vit
from rgbnomore_tpu.train.config import amp_compute_dtype as jax_amp_compute_dtype
from rgbnomore_tpu.train.config import build_model as jax_build_model
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from torch_port_support import perturb_norms
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.models import embeddings, layers, swinv2, vit
from rgbnomore_tpu_torch.train.config import amp_compute_dtype, build_model, generate_config

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp16": (torch.float16, jnp.float16)}
MODULE_TOL = {"bf16": 2**-5, "fp16": 2**-8}
LOGIT_TOL = {"bf16": 2**-4, "fp16": 2**-7}
ERR_FACTOR = 4.0


@pytest.fixture(autouse=True)
def torch_bias_family():
    """The JAX init's bias family is a global (``set_bias_family``); the
    parity tests draw with the default one."""
    jax_embeddings.set_bias_family("torch")


@contextlib.contextmanager
def jax_fused_window_path():
    """JAX's SwinV2 on its Pallas window path (``use_fused_kernel``), which
    it takes on a TPU only: the backend reads as a TPU and the kernel runs
    in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(pallas_attention, "fused_window_attention",
                   functools.partial(pallas_attention.fused_window_attention, interpret=True))
        yield


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def torch_dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def check_parity(got, want, ref, tol, factor=ERR_FACTOR):
    """``got`` (port) and ``want`` (JAX) in the same dtype, within ``tol`` of
    the float32 output ``ref``'s scale of each other; each one's error
    against ``ref`` within ``factor`` of the other's."""
    assert torch_dtype_name(got) == str(want.dtype)
    g, w, r = to_np(got), to_np(want), to_np(ref)
    scale = float(np.abs(r).max())
    np.testing.assert_allclose(g, w, atol=tol * scale, rtol=tol)
    e_port, e_jax = float(np.abs(g - r).max()), float(np.abs(w - r).max())
    floor = 2**-12 * scale  # below this both are at float32's level
    assert e_port <= factor * max(e_jax, floor), (e_port, e_jax)
    assert e_jax <= factor * max(e_port, floor), (e_port, e_jax)


# ---------------------------------------------------------- the dtype policy
@pytest.mark.parametrize("amp,name", [
    (False, "bf16"), (False, "nonsense"), (True, "bf16"), (True, "bfloat16"), (True, "BF16"),
    (True, "fp16"), (True, "float16"), (True, "half"), (True, "Half"),
])
def test_amp_compute_dtype_matches_jax(amp, name, caplog):
    cfgs = [gen("vitti", "dct", amp=amp, ampdtype=name)
            for gen in (generate_config, jax_generate_config)]
    with caplog.at_level(logging.WARNING):
        got, want = amp_compute_dtype(cfgs[0]), jax_amp_compute_dtype(cfgs[1])
    assert str(got).removeprefix("torch.") == jnp.dtype(want).name
    fp16 = got == torch.float16
    assert fp16 == any("dynamic loss scaling" in r.message for r in caplog.records
                       if r.name.startswith("rgbnomore_tpu_torch"))


@pytest.mark.parametrize("name", ["fp8", "float32", "int8", ""])
def test_amp_compute_dtype_refuses_other_names(name):
    for gen, fn in ((generate_config, amp_compute_dtype),
                    (jax_generate_config, jax_amp_compute_dtype)):
        with pytest.raises(ValueError, match="unsupported ampdtype"):
            fn(gen("vitti", "dct", amp=True, ampdtype=name))
    cfg = generate_config("vitti", "dct", amp=True, ampdtype=name)
    cfg.model.depth = 1
    with pytest.raises(ValueError, match="unsupported ampdtype"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("preset,depth", [("vitb", 1), ("vitl", 1), ("swinv2", None)])
def test_amp_presets_build_in_bf16(preset, depth):
    """The presets that turn AMP on build (depth cut for the ViTs) and
    compute in bf16 with float32 parameters; one image gives float32
    logits."""
    cfg = generate_config(preset, "dct")
    assert cfg.train.amp and cfg.model.amp_dtype == "bf16"
    if depth is not None:
        cfg.model.depth = depth
    model = build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    nb = cfg.model.dct_blocks
    with torch.inference_mode():
        logits = model.eval()(torch.zeros((1, 1, nb, nb, 8, 8)),
                              torch.zeros((1, 2, nb // 2, nb // 2, 8, 8)))
    assert logits.dtype == torch.float32 and logits.shape == (1, 1000)
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------- the layers
@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("in_dtype", ["float32", "half"])
def test_linear_and_layernorm_follow_flax(tag, in_dtype, rng):
    """Linear(dtype) against flax ``Dense(dtype)``: the output in the dtype
    whatever the input's; LayerNorm against flax ``LayerNorm``: float32 out
    for a half input, statistics in float32."""
    import flax.linen as fnn

    tdt, jdt = DTYPES[tag]
    x = rng.standard_normal((6, 24)).astype(np.float32)
    jx = jnp.asarray(x) if in_dtype == "float32" else jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x) if in_dtype == "float32" else torch.from_numpy(x).to(tdt)
    dense = fnn.Dense(16, dtype=jdt)
    variables = dense.init(jax.random.PRNGKey(0), jx)
    lin = layers.Linear(24, 16, dtype=tdt)
    lin.load_state_dict({k.removeprefix("lin."): v for k, v in flax_to_state_dict(
        {"lin": jax.tree.map(np.asarray, variables["params"])}).items()})
    ref = fnn.Dense(16).apply(variables, jnp.asarray(x))
    check_parity(lin(tx), dense.apply(variables, jx), ref, MODULE_TOL[tag])
    assert lin.weight.dtype == torch.float32

    norm = fnn.LayerNorm(epsilon=1e-5)
    nvars = norm.init(jax.random.PRNGKey(1), jx)
    tnorm = layers.LayerNorm(24, eps=1e-5)
    got, want = tnorm(tx), norm.apply(nvars, jx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("h,w,e", [(14, 14, 192), (14, 14, 768), (8, 8, 96), (3, 5, 8)])
def test_sincos_in_half_is_bit_identical_to_jax(tag, h, w, e):
    """JAX builds the table in the input's dtype (the constant rounded to it
    first); so does the port, and the two agree bit for bit."""
    tdt, jdt = DTYPES[tag]
    want = jax_embeddings.sincos_position_embedding(h, w, e, jdt)
    got = embeddings.sincos_position_embedding(h, w, e, dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_array_equal(to_np(got), to_np(want))


# ----------------------------------------------------------- ViT modules
def _jax_init(module, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(2), *args)["params"])


@pytest.mark.parametrize("tag", DTYPES)
def test_dct_embedding_matches_flax(tag, rng):
    """The grouped DCT embedding (patch 16, emb 64) with its sincos table:
    the compute dtype out, values within MODULE_TOL."""
    tdt, jdt = DTYPES[tag]
    y = rng.standard_normal((2, 1, 8, 8, 8, 8)).astype(np.float32) * 30
    c = rng.standard_normal((2, 2, 4, 4, 8, 8)).astype(np.float32) * 30
    params = _jax_init(jax_embeddings.PatchEmbeddingDCTGroup(16, 64), y, c)
    ref = jax_embeddings.PatchEmbeddingDCTGroup(16, 64).apply({"params": params}, y, c)
    want = jax_embeddings.PatchEmbeddingDCTGroup(16, 64, dtype=jdt).apply({"params": params}, y, c)
    tmod = embeddings.PatchEmbeddingDCTGroup(16, 64, dtype=tdt)
    tmod.load_state_dict(flax_to_state_dict(params))
    got = tmod(torch.from_numpy(y), torch.from_numpy(c))
    assert got.shape == (2, 16, 64)
    check_parity(got, want, ref, MODULE_TOL[tag])


@pytest.mark.parametrize("tag", DTYPES)
def test_encoder_block_matches_flax(tag, rng):
    """A pre-LN block (emb 64, 2 heads of 32) on residual-stream input in
    the compute dtype: the output stays in it, as JAX's does."""
    tdt, jdt = DTYPES[tag]
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    params = _jax_init(jax_vit.EncoderBlock(64, 2, 32), x)
    ref = jax_vit.EncoderBlock(64, 2, 32).apply({"params": params}, jnp.asarray(x))
    want = jax_vit.EncoderBlock(64, 2, 32, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x).astype(jdt))
    tmod = vit.EncoderBlock(64, 2, 32, dtype=tdt)
    tmod.load_state_dict(flax_to_state_dict(params))
    got = tmod(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    check_parity(got, want, ref, MODULE_TOL[tag])


@pytest.mark.parametrize("tag", DTYPES)
def test_head_matches_flax(tag, rng):
    """LN (float32) -> mean -> linear1 in the dtype -> tanh -> linear2 on a
    float32 input: float32 logits."""
    tdt, jdt = DTYPES[tag]
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    params = _jax_init(jax_vit.ClassificationHead(64, 7), x)
    ref = jax_vit.ClassificationHead(64, 7).apply({"params": params}, jnp.asarray(x))
    want = jax_vit.ClassificationHead(64, 7, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x).astype(jdt))
    tmod = vit.ClassificationHead(64, 7, dtype=tdt)
    tmod.load_state_dict(flax_to_state_dict(params))
    got = tmod(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32
    check_parity(got, want, ref, MODULE_TOL[tag])


def _vit_cfg(gen, tag):
    cfg = gen("vitti", "dct", modelver=1, amp=tag is not None, ampdtype=tag or "bf16")
    cfg.model.depth, cfg.model.embed_size = 2, 64
    cfg.model.heads, cfg.model.head_size = 2, 32
    cfg.model.classes, cfg.model.dct_blocks = 5, 8
    return cfg


@pytest.mark.parametrize("tag", DTYPES)
def test_vit_logits_match_flax(tag, rng):
    """The ViT (depth 2, emb 64, 2 heads) built by ``build_model`` from an
    AMP config: float32 logits within LOGIT_TOL of JAX's."""
    y = rng.standard_normal((3, 1, 8, 8, 8, 8)).astype(np.float32) * 50
    c = rng.standard_normal((3, 2, 4, 4, 8, 8)).astype(np.float32) * 50
    jmodel32 = jax_build_model(_vit_cfg(jax_generate_config, None))
    params = jax.tree.map(np.asarray, jax.jit(jmodel32.init)(jax.random.PRNGKey(3), y, c))
    ref = jmodel32.apply(params, y, c)
    want = jax_build_model(_vit_cfg(jax_generate_config, tag)).apply(params, y, c)
    tmodel = build_model(_vit_cfg(generate_config, tag), device="cpu")
    assert tmodel.dtype == DTYPES[tag][0]
    tmodel.load_state_dict(flax_to_state_dict(params["params"]))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    check_parity(got, want, ref, LOGIT_TOL[tag])


# -------------------------------------------------------- SwinV2 modules
@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("in_dtype", ["half", "float32"])
def test_window_attention_matches_jax_fused_path(tag, in_dtype, rng):
    """SwinV2's window attention (dim 32, window 4, 2 heads, q and v biases
    non-zero) on the first block's half input and on a later block's
    float32 one (the qkv product promotes): equal to JAX's Pallas path to a
    few roundings of the dtype (bf16 bit for bit here; in fp16 two or three
    of 4,096 entries one or two units apart, where float32 sums in another
    order flip a rounding of q or k); within MODULE_TOL of JAX's einsum path.

    [float32-fp16]: the port's float32 qkv product (``linear_tf32x3``,
    3xTF32) sums in another order than JAX's float32 one, and flips the fp16
    rounding of six entries of k; through the softmax that flips the fp16
    rounding of the attention output, the proj's input, in two entries, and
    one output entry near zero (-9.1e-4) then misses 4 units of its own by
    1.2e-5.  There the module with JAX's float32 product (``F.linear``, then
    the bias) is held to the Pallas path at 4 units, and the port's module
    to 4 units plus one flipped rounding of one proj input in its row: the
    largest |W_proj[r, c]| times the fp16 unit of input c."""
    tdt, jdt = DTYPES[tag]
    x = rng.standard_normal((8, 16, 32)).astype(np.float32)
    params = _jax_init(jax_swinv2.WindowAttention(32, 4, 2), x, None)
    for name in ("q_bias", "v_bias"):
        params[name] = (rng.standard_normal(params[name].shape) * 0.5).astype(np.float32)
    jx = jnp.asarray(x) if in_dtype == "float32" else jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x) if in_dtype == "float32" else torch.from_numpy(x).to(tdt)
    ref = jax_swinv2.WindowAttention(32, 4, 2).apply({"params": params}, jnp.asarray(x), None)
    jmod = jax_swinv2.WindowAttention(32, 4, 2, dtype=jdt)
    with jax_fused_window_path():
        fused = jmod.clone(use_fused_kernel=True).apply({"params": params}, jx, None)
    einsum = jmod.apply({"params": params}, jx, None)
    tmod = swinv2.WindowAttention(32, 4, 2, dtype=tdt)
    tmod.load_state_dict(flax_to_state_dict(params))
    proj_in = []
    hook = tmod.proj.register_forward_pre_hook(lambda mod, args: proj_in.append(args[0]))
    with torch.no_grad():
        got = tmod(tx, None)
    hook.remove()
    assert torch_dtype_name(got) == str(fused.dtype) == str(einsum.dtype)
    ulp = 2.0**-7 if tag == "bf16" else 2.0**-10  # relative spacing of the dtype
    if (tag, in_dtype) != ("fp16", "float32"):
        np.testing.assert_allclose(to_np(got), to_np(fused), rtol=4 * ulp, atol=0)
    else:
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(swinv2, "linear_tf32x3",
                       lambda a, w, b: torch.nn.functional.linear(a, w.float()) + b)
            as_jax = tmod(tx, None)
        np.testing.assert_allclose(to_np(as_jax), to_np(fused), rtol=4 * ulp, atol=0)
        unit = np.spacing(np.abs(proj_in[0].numpy())).astype(np.float32)  # (bw, n, c)
        weight = np.abs(tmod.proj.weight.detach().float().numpy())  # (c out, c in)
        one_flip = (unit[..., None, :] * weight).max(-1)  # (bw, n, c out)
        g, f = to_np(got), to_np(fused)
        assert np.all(np.abs(g - f) <= 4 * ulp * np.abs(f) + one_flip), (
            float((np.abs(g - f) - 4 * ulp * np.abs(f) - one_flip).max()))
    check_parity(got, einsum, ref, MODULE_TOL[tag])


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_swin_block_matches_jax(tag, shift, rng):
    """A res-post-norm block (dim 32, 8x8 tokens, window 4, norms
    perturbed) on the first block's half input: a float32 output (the
    post-norm promotes the residual), as JAX's; within MODULE_TOL of JAX's
    Pallas path and of its einsum path."""
    tdt, jdt = DTYPES[tag]
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    args = (32, (8, 8), 2, 4, shift)
    params = perturb_norms(_jax_init(jax_swinv2.SwinBlock(*args), x), rng)
    ref = jax_swinv2.SwinBlock(*args).apply({"params": params}, jnp.asarray(x))
    jmod = jax_swinv2.SwinBlock(*args, dtype=jdt)
    jx = jnp.asarray(x).astype(jdt)
    with jax_fused_window_path():
        fused = jmod.clone(use_fused_attention=True).apply({"params": params}, jx)
    einsum = jmod.apply({"params": params}, jx)
    tmod = swinv2.SwinBlock(*args, dtype=tdt)
    tmod.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32
    check_parity(got, fused, ref, MODULE_TOL[tag])
    check_parity(got, einsum, ref, MODULE_TOL[tag])


def _swin_cfg(gen, tag):
    """SwinV2 at embed 32, depths (2, 2), heads (2, 4), window 4, an 8x8
    block grid (16x16 tokens: 16 windows, then 4), 10 classes."""
    cfg = gen("swinv2", "dct", seed=5)
    cfg.model.depth, cfg.model.heads = (2, 2), (2, 4)
    cfg.model.embed_size, cfg.model.window_size = 32, 4
    cfg.model.pretrained_window_sizes = (0, 0)
    cfg.model.drop_path, cfg.model.classes = 0.0, 10
    cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    cfg.train.amp = tag is not None
    if tag is not None:
        cfg.model.amp_dtype = tag
    return cfg


@pytest.mark.parametrize("tag", DTYPES)
def test_swin_logits_match_jax(tag, rng):
    """SwinV2 (embed 32, depths (2, 2), norms perturbed) built by
    ``build_model`` from an AMP config: float32 logits within LOGIT_TOL of
    JAX's, on its Pallas window path and on its einsum path."""
    y = rng.standard_normal((2, 1, 8, 8, 8, 8)).astype(np.float32) * 50
    c = rng.standard_normal((2, 2, 4, 4, 8, 8)).astype(np.float32) * 50
    jmodel32 = jax_build_model(_swin_cfg(jax_generate_config, None))
    params = jax.tree.map(np.asarray, jax.jit(jmodel32.init)(jax.random.PRNGKey(3), y, c))
    params = {"params": perturb_norms(params["params"], np.random.default_rng(3))}
    ref = jmodel32.apply(params, y, c)
    jmodel = jax_build_model(_swin_cfg(jax_generate_config, tag))
    with jax_fused_window_path():
        fused = jmodel.clone(use_fused_attention=True).apply(params, y, c)
    einsum = jmodel.apply(params, y, c)
    tmodel = build_model(_swin_cfg(generate_config, tag), device="cpu")
    assert tmodel.dtype == DTYPES[tag][0]
    tmodel.load_state_dict(flax_to_state_dict(params["params"]))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.float32
    check_parity(got, fused, ref, LOGIT_TOL[tag])
    check_parity(got, einsum, ref, LOGIT_TOL[tag])
