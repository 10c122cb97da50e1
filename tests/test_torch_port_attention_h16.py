"""The ViT attention in bf16 and fp16 (mixed precision), on the CPU.

- ``attention_plain`` and the CPU path of ``fused_attention`` (autograd
  through it) in bf16 and fp16 against the JAX package's Pallas kernel in
  interpret mode on the same half-precision inputs
  (``rgbnomore_tpu/ops/pallas/attention.py``: products accumulated in
  float32, float32 softmax, outputs cast to the input dtype).
- The precision scheme of the half-precision CUDA kernels
  (``csrc/attention_h16_fwd.cu``, ``csrc/attention_h16_bwd.cu``), emulated
  in plain PyTorch at their rounding points: operands in the input dtype,
  exact products summed in float32; the forward's one exact softmax over a
  whole head (N <= 256; 128-key tiles with the online rescale above), P
  rounded to the input dtype only as the A operand of PV; the backward's
  P^T and dS rounded once each as operands of dV, dK and dQ; in fp16 a
  head's dO divided by a power of two where a bound on its dS passes 2^15,
  and the gradients multiplied by it.  Held to a float32 reference and to the Pallas kernel, as
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
from torch_port_support import launches
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
# Pallas gradient test's, an odd N, and an N past the 256 keys the kernels
# hold at once (the forward's 128-key tiles, the backward's key groups)
CASES = [((2, 3, 196, 64), VIT_SCALE), ((1, 2, 52, 24), 0.13), ((2, 2, 197, 32), VIT_SCALE),
         ((1, 2, 300, 64), VIT_SCALE)]
IDS = ["vit_head", "pallas_grad", "odd_n", "long_n"]
# keys the forward kernel holds at once: a whole head up to 256 (128 for D
# > 64); past that, tiles of 128 keys with the online softmax
WHOLE_HEAD_KEYS = {64: 256, 128: 128}
KEY_TILE = 128


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
def fp16_divisor(amax: torch.Tensor) -> torch.Tensor:
    """``h16::fp16_row_divisor``: 1 below 2^15 (or for a non-finite
    ``amax``), else the power of two 2^(e - 14), e the exponent of
    ``amax``."""
    e = torch.floor(torch.log2(amax.clamp_min(1.0)))
    return torch.where((amax >= 2.0**15) & torch.isfinite(amax), 2.0 ** (e - 14), 1.0)


def fp16_head_divisor(dout, v):
    """The power of two by which the backward kernel divides a head's fp16
    dO (and multiplies dq, dk, dv): ``fp16_divisor`` of the bound 2 max_i
    |dO_i| max_j |V_j| on the head's |dS|, (..., 1, 1)."""
    dmax = dout.float().norm(dim=-1).amax(-1)
    vmax = v.float().norm(dim=-1).amax(-1)
    return fp16_divisor(2 * dmax * vmax)[..., None, None]


def h16_fwd(q, k, v, scale):
    """(out in the input dtype, float32 lse) as the forward kernel computes
    them: exact products summed in float32; while the kernel holds the
    whole head's keys, one exact softmax (the row's max, P, its sum), P
    rounded for PV; else per 128-key tile, P under the running max rounded
    for PV, the sum and O rescaled as the max grows."""
    s = q.float() @ k.float().transpose(-1, -2) * scale
    vf = v.float()
    n, d = s.shape[-1], q.shape[-1]
    tile = n if n <= WHOLE_HEAD_KEYS[64 if d <= 64 else 128] else KEY_TILE
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (d,))
    for k0 in range(0, n, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(q.dtype).float() @ vf[..., k0:k0 + tile, :]
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def h16_bwd(q, k, v, out, lse, dout, scale, guard_range=True):
    """(dq, dk, dv) as the backward kernel computes them: P, dP, dS in
    float32, P^T rounded once as dV's A operand, dS rounded once as dK's A
    operand (rows of dS^T) and once as dQ's (rows of dS, the tile it keeps
    in shared memory); delta = rowsum(dO * O) in float32; in fp16 (unless
    ``guard_range`` is False) dO divided by the head's ``fp16_head_divisor``
    s, rounded to fp16, and dq, dk, dv multiplied by s."""
    t = q.dtype
    s = torch.ones(())
    if guard_range and t == torch.float16:
        s = fp16_head_divisor(dout, v)
        dout = (dout.float() / s).to(t)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    dv = p.transpose(-1, -2).to(t).float() @ gf * s
    dp = gf @ vf.transpose(-1, -2)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = ds.to(t).float() @ kf * (scale * s)
    dk = ds.transpose(-1, -2).to(t).float() @ qf * (scale * s)
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
    "aligned": dO = 8000 V and q = k = 1.6 sqrt(64 / D) N(0, 1) (a 64-wide
    head's logits at any D), so each row's own key dominates its softmax and
    dS reaches about 1.7e5 (3.5e5 at D = 128), past fp16's range, while dq,
    dk and dv stay inside it.  (At D = 128 without the sqrt(64 / D), the
    softmax is nearly one-hot and delta, summed from the fp16 O, cancels to
    4.2e-3 of dq's largest entry, whatever the guard.)"""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x, v, g = (torch.randn(shape, generator=gen) for _ in range(3))
    if kind == "random":
        q, k = x.half(), torch.randn(shape, generator=gen).half()
        return q, k, v.half(), (g * 2.0**13).half()
    q = (1.6 * (64 / shape[-1]) ** 0.5 * x).half()
    return q, q.clone(), v.half(), (8000.0 * v.half().float()).half()


# loss-scaled fp16 cases: ViT-B's head, and the backward's key groups (N past
# 256; N past 128 at D > 64), each with dO V^T past 65504 ("random") and dS
# too ("aligned")
LARGE_DOUT = [("random", (1, 2, 196, 64)), ("aligned", (1, 2, 196, 64)),
              ("random", (1, 2, 300, 64)), ("aligned", (1, 2, 300, 64)),
              ("random", (1, 2, 200, 128)), ("aligned", (1, 2, 200, 128))]
LARGE_DOUT_IDS = ["random", "aligned", "random-long_n", "aligned-long_n", "random-d128",
                  "aligned-d128"]


@pytest.mark.parametrize("kind,shape", LARGE_DOUT, ids=LARGE_DOUT_IDS)
def test_fp16_scheme_guards_the_range_of_ds(kind, shape):
    """A loss-scaled fp16 output gradient: the scheme's dq, dk, dv are
    finite wherever the float32 reference's are (rounded to fp16) and within
    GRAD_TOL; where dS passes fp16's range ("aligned"), rounding it to fp16
    without the row guard overflows dq and dk."""
    scale = 1.0 / 768**0.5
    q, k, v, g = large_dout_case(kind, shape=shape)
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
    """fp16's guard (the head's divisor of dO): 1 while the bound on |dS|
    stays below 2^15, so the scheme is the unguarded one bit for bit; above,
    a power of two that keeps every bit of each normal dO value."""
    q, k, v, g = (x[:, :1] for x in large_dout_case("random"))
    scale = 1.0 / 768**0.5
    out, lse = h16_fwd(q, k, v, scale)
    small = (g.float() * 2.0**-13).half()
    assert float(fp16_head_divisor(small, v)) == 1.0
    for a, b in zip(h16_bwd(q, k, v, out, lse, small, scale),
                    h16_bwd(q, k, v, out, lse, small, scale, guard_range=False)):
        assert torch.equal(a, b)
    div = fp16_head_divisor(g, v)
    assert float(div) >= 2.0 and float(torch.log2(div)) == int(torch.log2(div))
    normal = g.float().abs() >= 2.0**-14 * div
    assert torch.equal(((g.float() / div).half().float() * div)[normal], g.float()[normal])


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


@pytest.mark.parametrize("symbol,want", [
    ("_ZN53_GLOBAL__N__f5d8e41f_20_attention_h16_fwd_cu_dea5952629attention_h16_fwd_head_kernel"
     "I13__nv_bfloat16Li1ELi13EEEvPKT_S4_S4_PS2_Pfiifb",
     "attention_h16_fwd_head_kernel<bfloat16,1,13>"),
    ("_ZN53_GLOBAL__N__f5d8e41f_20_attention_h16_fwd_cu_dea5952630attention_h16_fwd_tiled_kernel"
     "I6__halfLi1EEEvPKT_S4_S4_PS2_Pfiifb", "attention_h16_fwd_tiled_kernel<half,1>"),
    ("_ZN53_GLOBAL__N__6e49a609_20_attention_h16_bwd_cu_a929bba724attention_h16_bwd_kernel"
     "I6__halfLi1ELi13EEEvPKT_S4_S4_S4_S4_PKfPfPS2_S8_S8_iiffb",
     "attention_h16_bwd_kernel<half,1,13>"),
], ids=["fwd_head", "fwd_tiled", "bwd"])
def test_build_log_names_kernel_instances(symbol, want):
    """``chip_smoke`` reads each kernel instance's name and template
    arguments from ptxas's mangled symbol by its length prefixes (the
    digits in ``h16`` are not one), which picks the main-path instance's
    registers and spills for the report."""
    import chip_smoke

    assert chip_smoke.kernel_instance(symbol) == want
    line = f"ptxas info    : Compiling entry function '{symbol}' for 'sm_90a'"
    assert chip_smoke.mangled_kernel(line) == want.split("<")[0]


def test_cpu_path_launches_no_kernel():
    q = torch.zeros((1, 1, 4, 8), dtype=torch.float16)
    before = (launches("fused_attention_h16_fwd"), launches("fused_attention_h16_bwd"))
    fused_attention(q, q, q, 0.1)
    assert (launches("fused_attention_h16_fwd"), launches("fused_attention_h16_bwd")) == before


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


CARD_SHAPES = [(256, 12, 196, 64), (256, 3, 196, 64), (2, 3, 197, 64), (1, 2, 52, 24),
               (2, 3, 49, 32), (2, 3, 128, 128), (2, 2, 17, 20), (1, 2, 300, 64),
               (1, 2, 200, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(shape, tag):
    """The kernels through ``fused_attention`` against the plain version in
    the same dtype and against the float32 reference; one launch each,
    counted by the half-precision wrappers, none of the float32 kernels."""
    _card()
    dtype = DTYPES[tag][0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / (shape[1] * shape[3]) ** 0.5
    f32_before = (launches("fused_attention_fwd"), launches("fused_attention_bwd"))
    before = (launches("fused_attention_h16_fwd"), launches("fused_attention_h16_bwd"))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fused_attention(*leaves, scale)
    out.backward(g)
    torch.cuda.synchronize()
    assert (launches("fused_attention_h16_fwd"), launches("fused_attention_h16_bwd")) \
        == (before[0] + 1, before[1] + 1)
    assert (launches("fused_attention_fwd"), launches("fused_attention_bwd")) == f32_before
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
@pytest.mark.parametrize("kind,shape", [(kind, (8, 12, 196, 64) if shape == (1, 2, 196, 64)
                                         else shape) for kind, shape in LARGE_DOUT],
                         ids=LARGE_DOUT_IDS)
def test_fp16_large_output_gradient_on_card(kind, shape):
    """A loss-scaled fp16 dO (``large_dout_case``: dO V^T, and for
    "aligned" dS too, past 65504), at ViT-B's head and at each key-group
    instance of the backward: the kernel's dq, dk, dv are finite wherever
    the float32 reference's are, and within GRAD_TOL."""
    _card()
    scale = 1.0 / 768**0.5
    q, k, v, g = (t.cuda() for t in large_dout_case(kind, shape=shape))
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


@pytest.mark.cuda
@pytest.mark.parametrize("tag", DTYPES)
def test_backward_keeps_ds_on_chip_at_vitb_shape(tag):
    """The backward at ViT-B's eval shape (256, 12, 196, 64) through
    ``fused_attention``: one launch of the half-precision backward per
    backward pass, no device buffer beyond dq, dk and dv while it runs (the
    former design allocated a (B, H, N, N) float32 dS scratch, 472 MB at
    this shape), and two runs give bit-identical gradients."""
    _card()
    dtype = DTYPES[tag][0]
    shape = (256, 12, 196, 64)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fused_attention(*leaves, VIT_SCALE)
        torch.cuda.synchronize()
        before = launches("fused_attention_h16_bwd")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out.backward(g)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        assert launches("fused_attention_h16_bwd") == before + 1
        # dq, dk, dv and the contiguous copy autograd may make of g; a
        # (B, H, N, N) float32 buffer would add 472 MB
        assert grown <= 4 * q.numel() * q.element_size() + 2**20, grown
        assert grown < shape[0] * shape[1] * shape[2] ** 2 * 4
        grads.append([leaf.grad for leaf in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
