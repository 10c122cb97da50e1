"""The precision scheme of the window attention kernels, 3xTF32, on the CPU.

``csrc/window_attention_fwd.cu`` and ``csrc/window_attention_bwd.cu``
compute every float32 matrix product on the tensor cores in 3xTF32
(``csrc/tf32_mma.cuh``, emulated by ``torch_port_support.mm_3xtf32``), with
the bias added in float32 after QKᵀ.  The kernels run only on a card; here
a plain-PyTorch emulation of what they compute holds the scheme to the
Pallas kernel in interpret mode on the same numpy inputs (the bias mapped
between the two layouts by ``_pairs_to_port``), at the Pallas tests'
tolerances (forward atol 2e-5 / rtol 1e-5, ``tests/test_pallas_attention.py:
97``; gradients atol 5e-4 / rtol 1e-3, ``:120``).  q is scaled as SwinV2
scales it: cosine-normalised, times its initial logit scale of 10.  At the
clamp's scale of 100 (``models/swinv2.py:147``) the scheme's error against a
float64 reference stays within 4x the float32 einsum path's own, and at least
10x below one TF32 pass's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.ops.pallas.attention import fused_window_attention
from test_torch_port_window_attention import _pairs_to_port
from torch_port_support import mm_1xtf32, mm_3xtf32
from rgbnomore_tpu_torch.ops.window_attention import (
    window_attention_bwd_plain,
    window_attention_plain,
)

FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
# (bw, h, n, d, P) in the port's layout: SwinV2-T's stage 1 at batch 1,
# unshifted and shifted, a ragged window and head dim, the Pallas test's
CASES = [(64, 3, 64, 32, 2), (64, 3, 64, 32, 64), (6, 3, 49, 40, 6), (4, 2, 16, 8, 4)]
IDS = ["stage1", "stage1_shifted", "ragged", "pallas_test"]
INIT_SCALE = 10.0  # SwinV2's logit scale at init
CLAMP_SCALE = 100.0  # its clamp, exp(log(1 / 0.01))


def window_fwd(q, k, v, bias, mm):
    """O as the forward kernel computes it: S = QKᵀ through ``mm`` plus the
    bias in float32, the unnormalised softmax through ``mm`` with V, divided
    by the row sum."""
    bw, h, n, _ = q.shape
    p = bias.shape[0]
    s = mm(q, k.transpose(-1, -2))
    s = (s.reshape(bw // p, p, h, n, n) + bias).reshape(bw, h, n, n)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(e, v) / e.sum(-1, keepdim=True)


def window_bwd(q, k, v, bias, dout, mm):
    """(dq, dk, dv, dbias) as the backward kernel computes them: the five
    products through ``mm``, P normalised before dV = Pᵀ dO, dS = P (dP -
    rowsum(dP P)), the bias gradient summed over each pattern's windows."""
    bw, h, n, _ = q.shape
    p = bias.shape[0]
    s = mm(q, k.transpose(-1, -2))
    s = (s.reshape(bw // p, p, h, n, n) + bias).reshape(bw, h, n, n)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    prob = e / e.sum(-1, keepdim=True)
    dv = mm(prob.transpose(-1, -2), dout)
    dp = mm(dout, v.transpose(-1, -2))
    ds = prob * (dp - (prob * dp).sum(-1, keepdim=True))
    db = ds.reshape(bw // p, p, h, n, n).sum(0)
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv, db


def make_inputs(case, scale, seed=20261):
    """q (cosine-normalised, times ``scale``), k (normalised), v, dout and a
    bias in the CPB range [0, 16) with -100 on about a quarter of each
    pattern's entries where P > 1 (a shift mask), as numpy float32."""
    bw, h, n, d, p = case
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((bw, h, n, d)) for _ in range(4))
    q = scale * q / np.linalg.norm(q, axis=-1, keepdims=True)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    bias = 16.0 * rng.random((p, h, n, n))
    if p > 1:
        bias -= 100.0 * (rng.random((p, 1, n, n)) < 0.25)
    return tuple(x.astype(np.float32) for x in (q, k, v, g, bias))


def _port_to_pairs(bias: np.ndarray) -> np.ndarray:
    """(P, H, N, N) -> the Pallas kernel's (P / 2, H, 2N, 2N), -1e9 off the
    diagonal blocks; ``_pairs_to_port`` inverts it."""
    p, h, n, _ = bias.shape
    out = np.full((p // 2, h, 2 * n, 2 * n), -1e9, np.float32)
    out[:, :, :n, :n] = bias[0::2]
    out[:, :, n:, n:] = bias[1::2]
    return out


@functools.lru_cache(maxsize=None)
def pallas_case(case):
    """Inputs at SwinV2's initial scale, and the Pallas kernel's output and
    (dq, dk, dv, dbias) for them (interpret mode)."""
    q, k, v, g, bias = make_inputs(case, INIT_SCALE)
    bias2 = _port_to_pairs(bias)
    assert np.array_equal(_pairs_to_port(bias2), bias)
    out, vjp = jax.vjp(lambda *a: fused_window_attention(*a, True),
                       *map(jnp.asarray, (q, k, v, bias2)))
    dq, dk, dv, db2 = vjp(jnp.asarray(g))
    grads = (np.asarray(dq), np.asarray(dk), np.asarray(dv), _pairs_to_port(np.asarray(db2)))
    return (q, k, v, g, bias), np.asarray(out), grads


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_window_forward_matches_pallas(case):
    (q, k, v, _, bias), want, _ = pallas_case(case)
    got = window_fwd(*_torch(q, k, v, bias), mm_3xtf32)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_window_backward_matches_pallas(case):
    """All five products of the VJP in 3xTF32 against jax.vjp through the
    Pallas kernel, the bias gradient included."""
    (q, k, v, g, bias), _, want = pallas_case(case)
    got = window_bwd(*_torch(q, k, v, bias, g), mm_3xtf32)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **GRAD_TOL)


def _errors(case, mm_fns):
    """Max abs error of (out, dq, dk, dv, dbias) against float64 at the
    clamp's scale, for each of ``mm_fns`` (name -> mm, or None for the
    float32 einsum path of ``window_attention_plain`` and autograd)."""
    q, k, v, g, bias = make_inputs(case, CLAMP_SCALE)
    t64 = _torch(q, k, v, g, bias, dtype=torch.float64)
    ref = [window_fwd(*t64[:3], t64[4], torch.matmul),
           *window_bwd(*t64[:3], t64[4], t64[3], torch.matmul)]
    errs = {}
    for name, mm in mm_fns.items():
        tq, tk, tv, tg, tb = _torch(q, k, v, g, bias)
        if mm is None:
            got = [window_attention_plain(tq, tk, tv, tb),
                   *window_attention_bwd_plain(tq, tk, tv, tb, tg)]
        else:
            got = [window_fwd(tq, tk, tv, tb, mm), *window_bwd(tq, tk, tv, tb, tg, mm)]
        errs[name] = [float((a.double() - w).abs().max()) for a, w in zip(got, ref)]
    return errs


OUTPUTS = ("out", "dq", "dk", "dv", "dbias")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_window_error_near_float32(case):
    """At the clamp's logit scale, the 3xTF32 error against float64 is at
    most 4x the float32 einsum path's own error."""
    errs = _errors(case, {"3x": mm_3xtf32, "f32": None})
    for name, e3, e32 in zip(OUTPUTS, errs["3x"], errs["f32"]):
        assert e3 <= 4 * e32, f"{name}: 3xTF32 err {e3:.3e} beyond 4x float32's {e32:.3e}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_window_error_far_below_one_tf32_pass(case):
    """At the clamp's logit scale, the 3xTF32 error against float64 is at
    least 10x below that of the same computation in one TF32 pass."""
    errs = _errors(case, {"3x": mm_3xtf32, "1x": mm_1xtf32})
    for name, e3, e1 in zip(OUTPUTS, errs["3x"], errs["1x"]):
        assert e3 * 10 <= e1, f"{name}: 3xTF32 err {e3:.3e} not 10x below one pass's {e1:.3e}"
