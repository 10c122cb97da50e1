"""The ViT attention in bf16 and fp16 (mixed precision), on the CPU.

- ``attention_plain`` and the CPU path of ``fused_attention`` (autograd
  through it) in bf16 and fp16 against the JAX package's Pallas kernel in
  interpret mode on the same half-precision inputs
  (``rgbnomore_tpu/ops/pallas/attention.py``: products accumulated in
  float32, float32 softmax, outputs cast to the input dtype).
- The precision scheme of the half-precision CUDA kernels
  (``csrc/attention_h16_fwd.cu``, ``csrc/attention_h16_bwd.cu``), emulated
  in plain PyTorch: operands in the input dtype, exact products summed in
  float32, P (and dS) rounded to the input dtype only as an operand of its
  product, fp16 rows of dS beyond 2^15 divided by a power of two around
  their product.  Held to a float32 reference and to the Pallas kernel, as
  ``test_torch_port_attention_tf32.py`` holds the 3xTF32 scheme.
- Tests marked ``cuda`` run the kernels on a card.

Tolerances, for outputs of order 1 (inputs N(0, 1)): the forward within
atol 2^-6 / rtol 2^-7 in bf16 and 2^-9 / 2^-10 in fp16 (a few units of
each dtype's rounding, 2^-8 and 2^-11); gradients within 2^-5 (bf16) and
2^-8 (fp16) of the largest entry of the float32 reference's gradient.  The
kernel against the plain version: twice those.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.ops.pallas.attention import fused_attention as pallas_attention
from rgbnomore_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    fused_attention,
    fused_attention_h16_bwd,
    fused_attention_h16_fwd,
)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp16": (torch.float16, jnp.float16)}
FWD_TOL = {"bf16": dict(atol=2**-6, rtol=2**-7), "fp16": dict(atol=2**-9, rtol=2**-10)}
GRAD_TOL = {"bf16": 2**-5, "fp16": 2**-8}
VIT_SCALE = 1.0 / 192**0.5
# (shape, scale): a ViT-Ti head (ViT-B's heads are the same 196 x 64), the
# Pallas gradient test's, an odd N
CASES = [((2, 3, 196, 64), VIT_SCALE), ((1, 2, 52, 24), 0.13), ((2, 2, 197, 32), VIT_SCALE)]
IDS = ["vit_head", "pallas_grad", "odd_n"]


@functools.lru_cache(maxsize=None)
def case_data(shape, scale, tag):
    """Seeded q, k, v, dout rounded to the dtype (torch), and the Pallas
    kernel's output and gradients on them (interpret mode), as float32
    numpy."""
    tdt, jdt = DTYPES[tag]
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
                  for _ in range(4))
    j = [jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v, g)]
    out, vjp = jax.vjp(lambda a, b, c: pallas_attention(a, b, c, scale, True), *j[:3])
    grads = vjp(j[3])
    assert out.dtype == jdt and all(x.dtype == jdt for x in grads)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return (q, k, v, g), as_np(out), tuple(as_np(x) for x in grads)


def rel_err(got, want) -> float:
    """Max abs error as a share of the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def reference(q, k, v, g, scale):
    """The float32 output and gradients on the same rounded inputs."""
    with torch.no_grad():
        out = attention_plain(q.float(), k.float(), v.float(), scale)
    return out, attention_bwd_plain(q.float(), k.float(), v.float(), g.float(), scale)


# ------------------------------------------------------------ the scheme
def round_rows(x: torch.Tensor, dtype: torch.dtype, chunk: int = 16) -> torch.Tensor:
    """``x`` (float32, ..., M, K) rounded to ``dtype`` as an A operand of
    the kernels: in fp16, each row's 16-column chunk whose largest magnitude
    reaches 2^15 is divided by the power of two 2^(e - 14) (e its exponent)
    before the rounding and multiplied by it after (``h16::fp16_row_divisor``);
    bf16 rounds as it is."""
    if dtype != torch.float16:
        return x.to(dtype).float()
    *lead, m, kk = x.shape
    pad = (-kk) % chunk
    xc = torch.nn.functional.pad(x, (0, pad)).reshape(*lead, m, -1, chunk)
    amax = xc.abs().amax(-1, keepdim=True)
    e = torch.floor(torch.log2(amax.clamp_min(1.0)))
    div = torch.where((amax >= 2.0**15) & torch.isfinite(amax), 2.0 ** (e - 14), 1.0)
    out = (xc / div).to(dtype).float() * div
    return out.reshape(*lead, m, -1)[..., :kk]


def h16_fwd(q, k, v, scale):
    """(out in the input dtype, float32 lse) as the forward kernel computes
    them: exact products summed in float32, P rounded for PV."""
    s = q.float() @ k.float().transpose(-1, -2) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = p.to(q.dtype).float() @ v.float() / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def h16_bwd(q, k, v, out, lse, dout, scale, guard_range=True):
    """(dq, dk, dv) as the backward kernel computes them: P, dP, dS in
    float32, P^T and dS rounded (fp16 rows guarded unless ``guard_range``
    is False) as A operands, delta = rowsum(dO * O) in float32."""
    t = q.dtype
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    dv = p.transpose(-1, -2).to(t).float() @ gf
    dp = gf @ vf.transpose(-1, -2)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    rows = round_rows if guard_range else (lambda x, dt: x.to(dt).float())
    dq = rows(ds, t) @ kf * scale
    dk = rows(ds.transpose(-1, -2), t) @ qf * scale
    return dq.to(t), dk.to(t), dv.to(t)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_plain_matches_pallas(shape, scale, tag):
    """``attention_plain`` (the einsum path of JAX's ViT) and the CPU path
    of ``fused_attention`` in the half dtype against the Pallas kernel on
    the same inputs, and against the float32 reference; same output dtype."""
    (q, k, v, _), want, _ = case_data(shape, scale, tag)
    ref, _ = reference(*case_data(shape, scale, tag)[0], scale)
    for fn in (attention_plain, fused_attention):
        got = fn(q, k, v, scale)
        assert got.dtype == DTYPES[tag][0]
        np.testing.assert_allclose(got.float().numpy(), want, **FWD_TOL[tag])
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), **FWD_TOL[tag])


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_plain_gradients_match_pallas_vjp(shape, scale, tag):
    """Autograd through ``fused_attention``'s CPU path in the half dtype
    against the Pallas kernel's VJP on the same inputs and output gradient,
    in the dtype, within GRAD_TOL of the largest entry."""
    (q, k, v, g), _, want = case_data(shape, scale, tag)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention(*leaves, scale).backward(g)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == DTYPES[tag][0]
        assert rel_err(leaf.grad.float().numpy(), w) <= GRAD_TOL[tag]


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_kernel_scheme_forward(shape, scale, tag):
    """The forward kernel's scheme against the Pallas kernel and the float32
    reference at FWD_TOL, its lse against the float32 log-sum-exp, and no
    less accurate than the plain version by more than a factor of 2."""
    (q, k, v, g), want, _ = case_data(shape, scale, tag)
    ref, _ = reference(q, k, v, g, scale)
    out, lse = h16_fwd(q, k, v, scale)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want, **FWD_TOL[tag])
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), **FWD_TOL[tag])
    s = q.double() @ k.double().transpose(-1, -2) * scale
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5, rtol=1e-6)
    e_scheme = float((out.float() - ref).abs().max())
    e_plain = float((attention_plain(q, k, v, scale).float() - ref).abs().max())
    assert e_scheme <= 2 * e_plain


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_kernel_scheme_backward(shape, scale, tag):
    """The backward kernel's scheme against the Pallas kernel's VJP and the
    float32 reference, within GRAD_TOL of the largest entry, in the dtype."""
    (q, k, v, g), _, want = case_data(shape, scale, tag)
    _, ref = reference(q, k, v, g, scale)
    out, lse = h16_fwd(q, k, v, scale)
    for got, w, r in zip(h16_bwd(q, k, v, out, lse, g, scale), want, ref):
        assert got.dtype == q.dtype
        assert rel_err(got.float().numpy(), w) <= GRAD_TOL[tag]
        assert rel_err(got.float().numpy(), r.numpy()) <= GRAD_TOL[tag]


def large_dout_case(kind: str, seed: int = 3, shape=(1, 2, 196, 64)):
    """fp16 inputs with a loss-scaled output gradient (ViT-B's scale
    1/sqrt(768)).  "random": dO ~ N(0, 1) x 2^13, whose dO V^T passes
    fp16's 65504 while dS (bounded by P (1 - P) |dP|) stays below it;
    "aligned": dO = 8000 V and q = k = 1.6 N(0, 1), so each row's own key
    dominates its softmax and dS reaches about 1.9e5, past fp16's range,
    while dq, dk and dv stay inside it."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x, v, g = (torch.randn(shape, generator=gen) for _ in range(3))
    if kind == "random":
        q, k = x.half(), torch.randn(shape, generator=gen).half()
        return q, k, v.half(), (g * 2.0**13).half()
    q = (1.6 * x).half()
    return q, q.clone(), v.half(), (8000.0 * v.half().float()).half()


@pytest.mark.parametrize("kind", ["random", "aligned"])
def test_fp16_scheme_guards_the_range_of_ds(kind):
    """A loss-scaled fp16 output gradient: the scheme's dq, dk, dv are
    finite wherever the float32 reference's are (rounded to fp16) and within
    GRAD_TOL; where dS passes fp16's range ("aligned"), rounding it to fp16
    without the row guard overflows dq and dk."""
    scale = 1.0 / 768**0.5
    q, k, v, g = large_dout_case(kind)
    _, ref = reference(q, k, v, g, scale)
    out, lse = h16_fwd(q, k, v, scale)
    dp = g.float() @ v.float().transpose(-1, -2)
    p = torch.exp(q.float() @ k.float().transpose(-1, -2) * scale - lse[..., None])
    ds_max = float((p * (dp - (g.float() * out.float()).sum(-1, keepdim=True))).abs().max())
    assert float(dp.abs().max()) > 65504
    assert (ds_max > 65504) == (kind == "aligned")
    for got, r in zip(h16_bwd(q, k, v, out, lse, g, scale), ref):
        assert bool(torch.isfinite(r.half()).all())
        assert bool(torch.isfinite(got).all())
        assert rel_err(got.float().numpy(), r.numpy()) <= GRAD_TOL["fp16"]
    naive = h16_bwd(q, k, v, out, lse, g, scale, guard_range=False)
    assert all(bool(torch.isfinite(x).all()) for x in naive) == (kind == "random")


def test_round_rows_is_exact_below_the_guard():
    """Below 2^15 the guard does nothing; above, it keeps every mantissa
    bit that fp16 keeps (a power-of-two division)."""
    x = torch.tensor([[1.0, -3.5, 40000.0, 1.0e-3] + [0.0] * 12,
                      [1.0, -3.5, 4.0, 1.0e-3] + [0.0] * 12])
    got = round_rows(x, torch.float16)
    assert torch.equal(got[1], x[1].half().float())
    assert got[0, 2] == 40000.0 and torch.isfinite(got).all()
    assert torch.equal(round_rows(x, torch.bfloat16), x.bfloat16().float())


@pytest.mark.parametrize("bad", [
    lambda q: q.float(),                        # dtypes differ
    lambda q: q.to(torch.float64),              # float64
], ids=["mixed", "float64"])
def test_refuses_mixed_or_unsupported_dtypes(bad):
    q, k, v = (torch.zeros((1, 1, 4, 8), dtype=torch.bfloat16) for _ in range(3))
    with pytest.raises(TypeError):
        fused_attention(bad(q), k, v, 0.1)


def test_half_kernel_wrappers_refuse_float32_and_cpu():
    q = torch.zeros((1, 1, 4, 8))
    with pytest.raises(TypeError):
        fused_attention_h16_fwd(q, q, q, 0.1)
    h = q.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_h16_fwd(h, h, h, 0.1)
    lse = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_h16_bwd(h, h, h, h, lse, h, 0.1)


def test_cpu_path_launches_no_kernel():
    q = torch.zeros((1, 1, 4, 8), dtype=torch.float16)
    before = (fused_attention_h16_fwd.launches, fused_attention_h16_bwd.launches)
    fused_attention(q, q, q, 0.1)
    assert (fused_attention_h16_fwd.launches, fused_attention_h16_bwd.launches) == before


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


CARD_SHAPES = [(256, 12, 196, 64), (256, 3, 196, 64), (2, 3, 197, 64), (1, 2, 52, 24),
               (2, 3, 49, 32), (2, 3, 128, 128), (2, 2, 17, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(shape, tag):
    """The kernels through ``fused_attention`` against the plain version in
    the same dtype and against the float32 reference; one launch each,
    counted by the half-precision wrappers, none of the float32 kernels."""
    _card()
    from rgbnomore_tpu_torch.ops.attention import fused_attention_bwd

    dtype = DTYPES[tag][0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / (shape[1] * shape[3]) ** 0.5
    f32_before = (fused_attention.launches, fused_attention_bwd.launches)
    before = (fused_attention_h16_fwd.launches, fused_attention_h16_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fused_attention(*leaves, scale)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fused_attention_h16_fwd.launches, fused_attention_h16_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert (fused_attention.launches, fused_attention_bwd.launches) == f32_before
    assert out.dtype == dtype
    ref_out, ref_grads = reference(q, k, v, g, scale)
    plain = attention_plain(q, k, v, scale)
    tol = FWD_TOL[tag]
    np.testing.assert_allclose(out.detach().float().cpu().numpy(), ref_out.cpu().numpy(), **tol)
    np.testing.assert_allclose(out.detach().float().cpu().numpy(), plain.detach().float().cpu()
                               .numpy(), atol=2 * tol["atol"], rtol=2 * tol["rtol"])
    for leaf, r, p in zip(leaves, ref_grads, attention_bwd_plain(q, k, v, g, scale)):
        assert leaf.grad.dtype == dtype
        assert rel_err(leaf.grad.float().cpu().numpy(), r.cpu().numpy()) <= GRAD_TOL[tag]
        assert rel_err(leaf.grad.float().cpu().numpy(), p.float().cpu().numpy()) \
            <= 2 * GRAD_TOL[tag]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "aligned"])
def test_fp16_large_output_gradient_on_card(kind):
    """A loss-scaled fp16 dO (``large_dout_case``: dO V^T, and for
    "aligned" dS too, past 65504): the kernel's dq, dk, dv are finite
    wherever the float32 reference's are, and within GRAD_TOL."""
    _card()
    scale = 1.0 / 768**0.5
    q, k, v, g = (t.cuda() for t in large_dout_case(kind, shape=(8, 12, 196, 64)))
    out, lse = fused_attention_h16_fwd(q, k, v, scale, with_lse=True)
    got = fused_attention_h16_bwd(q, k, v, out, lse, g, scale)
    _, ref = reference(q, k, v, g, scale)
    for a, r in zip(got, ref):
        finite_ref = torch.isfinite(r.half())
        assert bool(torch.isfinite(a)[finite_ref].all())
        assert rel_err(a.float().cpu().numpy(), r.cpu().numpy()) <= GRAD_TOL["fp16"]


@pytest.mark.cuda
@pytest.mark.parametrize("tag", DTYPES)
def test_kernel_backward_is_deterministic_on_card(tag):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    dtype = DTYPES[tag][0]
    q, k, v, g = (torch.randn((16, 12, 196, 64), generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    out, lse = fused_attention_h16_fwd(q, k, v, 0.036, with_lse=True)
    first = fused_attention_h16_bwd(q, k, v, out, lse, g, 0.036)
    again = fused_attention_h16_bwd(q, k, v, out, lse, g, 0.036)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
