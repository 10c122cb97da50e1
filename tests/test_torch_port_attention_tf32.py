"""The precision scheme of the ViT attention kernels, 3xTF32, on the CPU.

``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` compute every
float32 matrix product on the tensor cores in 3xTF32 (``csrc/tf32_mma.cuh``):
each operand x splits into hi = TF32(x), rounded to nearest with ties away
from zero (the rounding of ``cvt.rna.tf32.f32``), and lo = x - hi, which the
tensor core reads as TF32 (its low 13 bits dropped); then
``a b ~= a_hi b_lo + a_lo b_hi + a_hi b_hi``.  The kernels run only on a
card; here a plain-PyTorch emulation of that scheme holds it to the Pallas
kernel in interpret mode on the same numpy inputs, at the Pallas tests'
tolerances (forward atol 2e-5 / rtol 1e-4, ``tests/test_pallas_attention.py:
21-30``; gradients atol 5e-4 / rtol 1e-3, ``:33-50``), and shows that its
error against a float64 reference is at least 10x below one TF32 pass's, so
that a one-pass kernel could not pass as this design.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.ops.pallas.attention import fused_attention as pallas_attention
from torch_port_support import mm_1xtf32, mm_3xtf32, tf32_rna

VIT_SCALE = 1.0 / 192**0.5
# (shape, scale): a ViT-Ti head at batch 2, the Pallas gradient test's, a
# head of 128 x 128 (the forward test's widest)
CASES = [((2, 3, 196, 64), VIT_SCALE), ((1, 2, 52, 24), 0.13), ((2, 3, 128, 128), VIT_SCALE)]
IDS = ["vitti", "pallas_grad", "wide"]
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


def attention_fwd(q, k, v, scale, mm):
    """(out, lse) of softmax attention with every product through ``mm``."""
    s = mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


def attention_bwd(q, k, v, out, lse, dout, scale, mm):
    """(dq, dk, dv) from the five products of the VJP through ``mm``, P
    rebuilt from the lse, as the backward kernel computes them."""
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale - lse[..., None])
    dv = mm(p.transpose(-1, -2), dout)
    dp = mm(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    return mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale, dv


@functools.lru_cache(maxsize=None)
def case_data(shape, scale):
    """Seeded q, k, v, dout (numpy), and the Pallas kernel's output and
    gradients for them (interpret mode)."""
    rng = np.random.default_rng(20260)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: pallas_attention(a, b, c, scale, True),
                       *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(g))
    return (q, k, v, g), np.asarray(out), tuple(np.asarray(x) for x in grads)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# bit pattern -> its TF32 rounding: ties away from zero, a carry into the
# exponent, negatives, subnormals, overflow to infinity
RNA_CASES = {
    "tie_up": (0x3F801000, 0x3F802000),          # 1 + 2^-11 -> 1 + 2^-10, not to even 1
    "below_half": (0x3F800FFF, 0x3F800000),
    "above_half": (0x3F801001, 0x3F802000),
    "exact": (0x3FA00000, 0x3FA00000),
    "carry_into_exponent": (0x3FFFFFFF, 0x40000000),  # just below 2 -> 2
    "negative_tie": (-0x407FF000, -0x407FE000),  # -(1 + 2^-11) -> -(1 + 2^-10)
    "negative": (-0x405FEFFF, -0x405FE000),      # 0xBFA01001 -> 0xBFA02000
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_down": (0x00000FFF, 0x00000000),
    "overflow": (0x7F7FF000, 0x7F800000),        # rounds past the largest TF32 -> inf
}


@pytest.mark.parametrize("case", RNA_CASES.values(), ids=RNA_CASES.keys())
def test_tf32_rna_bit_patterns(case):
    given, want = case
    x = torch.tensor([given], dtype=torch.int32).view(torch.float32)
    got = tf32_rna(x).view(torch.int32).item()
    hexes = [f"{b & 0xFFFFFFFF:#010x}" for b in (given, got, want)]
    assert got == want, "{} -> {}, want {}".format(*hexes)


def test_tf32_rna_matches_float64_rounding():
    """Normal float32 values rounded to 11 significant bits in float64,
    ties away from zero, give the same values."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(100_000) * np.exp(rng.uniform(-30, 30, 100_000))
    x = x.astype(np.float32)
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    ulp = np.ldexp(1.0, e - 11)
    want = np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
    got = tf32_rna(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_3xtf32_forward_matches_pallas(shape, scale):
    (q, k, v, _), want, _ = case_data(shape, scale)
    got, _ = attention_fwd(*_torch(q, k, v), scale, mm_3xtf32)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_3xtf32_backward_matches_pallas(shape, scale):
    """All five products of the VJP in 3xTF32, from the emulated forward's
    output and lse, against jax.vjp through the Pallas kernel."""
    (q, k, v, g), _, want = case_data(shape, scale)
    tq, tk, tv, tg = _torch(q, k, v, g)
    out, lse = attention_fwd(tq, tk, tv, scale, mm_3xtf32)
    for got, w in zip(attention_bwd(tq, tk, tv, out, lse, tg, scale, mm_3xtf32), want):
        np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_3xtf32_error_far_below_one_tf32_pass(shape, scale):
    """Against float64, the 3xTF32 forward and gradients err at least 10x
    less than the same computation in one TF32 pass."""
    (q, k, v, g), _, _ = case_data(shape, scale)
    t64 = _torch(q, k, v, g, dtype=torch.float64)
    out64, lse64 = attention_fwd(*t64[:3], scale, torch.matmul)
    want = [out64, *attention_bwd(*t64[:3], out64, lse64, t64[3], scale, torch.matmul)]
    errs = {}
    for tag, mm in (("3x", mm_3xtf32), ("1x", mm_1xtf32)):
        tq, tk, tv, tg = _torch(q, k, v, g)
        out, lse = attention_fwd(tq, tk, tv, scale, mm)
        got = [out, *attention_bwd(tq, tk, tv, out, lse, tg, scale, mm)]
        errs[tag] = [float((a.double() - w).abs().max()) for a, w in zip(got, want)]
    for name, e3, e1 in zip(("out", "dq", "dk", "dv"), errs["3x"], errs["1x"]):
        assert e3 * 10 <= e1, f"{name}: 3xTF32 err {e3:.3e} not 10x below one pass's {e1:.3e}"
