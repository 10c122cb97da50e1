"""The port's window attention against the JAX package's Pallas kernel.

``window_attention_plain`` and the CPU path of ``window_attention`` are held
against ``rgbnomore_tpu.ops.pallas.attention.fused_window_attention`` in
interpret mode, on the same numpy inputs, at the Pallas tests' tolerances
(``tests/test_pallas_attention.py:91-143``): atol 2e-5, rtol 1e-5 forward;
the gradients of q, k, v and the bias at atol 5e-4, rtol 1e-3, including
the deep-accumulation case (12 windows, two pair patterns).

The bias maps between the two layouts: the Pallas kernel takes (NPAT, H,
2N, 2N) for consecutive window pairs (pair ``i`` uses pattern ``i % NPAT``,
-1e9 off the block diagonal); the port takes (P, H, N, N) with window ``w``
on pattern ``w % P``.  JAX's pattern ``(i % NPAT, slot)`` is the port's
``2 * (i % NPAT) + slot``, P = 2 * NPAT; the port's bias gradient is the
diagonal blocks of JAX's.  The CUDA kernels themselves run only on a card:
the tests marked ``cuda``: #3 and #4 (N <= 64) against the plain version at
the Pallas tests' tolerances, and #3L and #4L (64 < N <= 256, SwinV2 at
window 16) against float64 at a tolerance that operands rounded once to
TF32 fail, both bit-identical from run to run, and ``window_attention``'s
routing by N, read from the launch counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.ops.pallas.attention import fused_window_attention
from torch_port_support import launches
from rgbnomore_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_bwd_plain,
    window_attention_plain,
)

FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


def _pairs_to_port(bias2: np.ndarray) -> np.ndarray:
    """(NPAT, H, 2N, 2N) -> (2 * NPAT, H, N, N): the diagonal blocks."""
    npat, h, n2, _ = bias2.shape
    n = n2 // 2
    out = np.empty((2 * npat, h, n, n), np.float32)
    out[0::2] = bias2[:, :, :n, :n]
    out[1::2] = bias2[:, :, n:, n:]
    return out


def _inputs(rng, bw, h, n, d, npat, scale=1.0):
    """q, k, v (bw, h, n, d), the Pallas bias2 (npat, h, 2n, 2n) and the
    port's bias (2 npat, h, n, n)."""
    q, k, v = (rng.standard_normal((bw, h, n, d)).astype(np.float32) for _ in range(3))
    per = (rng.standard_normal((npat, 2, h, n, n)) * scale).astype(np.float32)
    bias2 = np.full((npat, h, 2 * n, 2 * n), -1e9, np.float32)
    bias2[:, :, :n, :n] = per[:, 0]
    bias2[:, :, n:, n:] = per[:, 1]
    return q, k, v, bias2, _pairs_to_port(bias2)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the Pallas test's shape, then one shape of each SwinV2-T stage (window 8,
# head dim 32): unshifted (one pattern for every pair) and shifted (nW/2
# pair patterns), at batch 1; stage 4 has one window per image and no shift,
# so it runs at batch 2 (the Pallas kernel pairs windows)
FWD_CASES = [
    (4, 2, 16, 8, 2),
    (64, 3, 64, 32, 1), (64, 3, 64, 32, 32),
    (16, 6, 64, 32, 1), (16, 6, 64, 32, 8),
    (4, 12, 64, 32, 1), (4, 12, 64, 32, 2),
    (2, 24, 64, 32, 1),
]
FWD_IDS = ["pallas_test", "stage1", "stage1_shifted", "stage2", "stage2_shifted", "stage3",
           "stage3_shifted", "stage4_batch2"]


@pytest.mark.parametrize("fn", [window_attention_plain, window_attention],
                         ids=["plain", "cpu_path"])
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_forward_matches_pallas(rng, case, fn):
    q, k, v, bias2, bias = _inputs(rng, *case)
    want = np.asarray(fused_window_attention(*map(jnp.asarray, (q, k, v, bias2)), True))
    got = fn(*_t(q, k, v, bias))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_gradients_match_pallas_vjp(rng):
    """Gradients of sum((attention - t)^2) in q, k, v and the bias through
    the port's autograd Function against jax.grad through the Pallas VJP
    (the Pallas test's bw 8, two pair patterns)."""
    q, k, v, bias2, bias = _inputs(rng, 8, 2, 16, 8, 2)
    t = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v, b):
        return jnp.sum((fused_window_attention(q, k, v, b, True) - jnp.asarray(t)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias2)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v, bias)]
    ((window_attention(*leaves) - torch.from_numpy(t)) ** 2).sum().backward()
    for name, leaf, w in zip("qkvb", leaves, want):
        w = np.asarray(w)
        if name == "b":
            w = _pairs_to_port(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=f"grad {name}", **GRAD_TOL)


def test_bias_grad_deep_accumulation(rng):
    """12 windows on two pair patterns: each of the port's 4 patterns sums
    the dS of 3 windows, the Pallas backward's accumulation depth m = 3."""
    q, k, v, bias2, bias = _inputs(rng, 12, 2, 16, 8, 2)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want = jax.grad(lambda b: jnp.sum(fused_window_attention(qj, kj, vj, b, True) ** 2))(
        jnp.asarray(bias2))
    b = torch.from_numpy(bias).requires_grad_(True)
    (window_attention(*_t(q, k, v), b) ** 2).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), _pairs_to_port(np.asarray(want)), **GRAD_TOL)


def test_shared_pattern_grad_is_sum_over_windows(rng):
    """With P = 1 every window shares the bias: its gradient is the sum of
    each window's alone."""
    q, k, v = _t(*(rng.standard_normal((6, 2, 9, 4)).astype(np.float32) for _ in range(3)))
    bias = torch.from_numpy(rng.standard_normal((1, 2, 9, 9)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 2, 9, 4)).astype(np.float32))
    db = window_attention_bwd_plain(q, k, v, bias, g)[3]
    each = sum(window_attention_bwd_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], bias,
                                          g[i:i + 1])[3] for i in range(6))
    np.testing.assert_allclose(db.numpy(), each.numpy(), atol=1e-6, rtol=1e-5)


def test_cpu_path_launches_no_kernel(rng):
    q, k, v, _, bias = _inputs(rng, 4, 2, 16, 8, 1)
    leaves = [x.requires_grad_(True) for x in _t(q, k, v, bias)]
    before = (launches("window_attention_fwd"), launches("window_attention_bwd"))
    window_attention(*leaves).sum().backward()
    assert (launches("window_attention_fwd"), launches("window_attention_bwd")) == before


def test_cpu_backward_is_autograd_through_plain(rng):
    q, k, v, _, bias = _inputs(rng, 4, 2, 16, 8, 2)
    g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v, bias)]
    window_attention(*leaves).backward(g)
    for leaf, w in zip(leaves, window_attention_bwd_plain(*_t(q, k, v, bias), g)):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("bad, error", [
    (lambda q, b: (q[0], b), ValueError),                        # rank 3
    (lambda q, b: (q.double(), b), TypeError),                   # float64
    (lambda q, b: (q, b.double()), TypeError),                   # float64 bias
    (lambda q, b: (q[..., :4], b), ValueError),                  # shape differs from k, v
    (lambda q, b: (q, b[:, :1]), ValueError),                    # bias heads
    (lambda q, b: (q, b[:3]), ValueError),                       # 4 windows, 3 patterns
    (lambda q, b: (q.transpose(2, 3).contiguous().transpose(2, 3), b), ValueError),
], ids=["rank", "float64", "bias_float64", "shape", "bias_heads", "patterns", "noncontiguous"])
def test_refuses_bad_inputs(rng, bad, error):
    q, k, v, _, bias = _inputs(rng, 4, 2, 16, 8, 2)
    q, bias = bad(*_t(q, bias))
    with pytest.raises(error):
        window_attention(q, *_t(k, v), bias)


@pytest.mark.parametrize("n,d", [(257, 8), (16, 65)], ids=["tokens", "head_dim"])
def test_refuses_beyond_the_kernel_limits(n, d):
    q = torch.zeros((2, 1, n, d))
    with pytest.raises(ValueError, match="N <= 256 and D <= 64"):
        window_attention(q, q, q, torch.zeros((1, 1, n, n)))


def test_takes_windows_of_256_tokens(rng):
    """SwinV2 at window 16: N = 256 passes the check (on the CPU, the plain
    path), and its gradient is autograd through the plain version."""
    q, k, v = _t(*(rng.standard_normal((2, 1, 256, 8)).astype(np.float32) for _ in range(3)))
    bias = torch.from_numpy(rng.standard_normal((2, 1, 256, 256)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 1, 256, 8)).astype(np.float32))
    leaves = [x.requires_grad_(True) for x in (q, k, v, bias)]
    window_attention(*leaves).backward(g)
    for leaf, w in zip(leaves, window_attention_bwd_plain(q, k, v, bias, g)):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("n", [64, 256])
def test_kernel_wrappers_refuse_cpu_tensors(n):
    """The kernels' wrappers, #3 and #4's and the tiled pair's, take CUDA
    tensors only."""
    from rgbnomore_tpu_torch.ops.window_attention import (window_attention_bwd,
                                                          window_attention_fwd,
                                                          window_attention_tiled_fwd)

    q = torch.zeros((2, 1, n, 8))
    bias = torch.zeros((1, 1, n, n))
    for call in (lambda: window_attention_tiled_fwd(q, q, q, bias),
                 lambda: window_attention_fwd(q, q, q, bias),
                 lambda: window_attention_bwd(q, q, q, bias, q)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


# ---------------------------------------------------------------- the card
# (bw, h, n, d, P): SwinV2-T's four stages at batch 2, unshifted and shifted,
# the Pallas tests' shapes and a ragged one
CARD_CASES = [(128, 3, 64, 32, 1), (128, 3, 64, 32, 64), (32, 6, 64, 32, 1),
              (32, 6, 64, 32, 16), (8, 12, 64, 32, 1), (8, 12, 64, 32, 4), (2, 24, 64, 32, 1),
              (4, 2, 16, 8, 4), (12, 2, 16, 8, 4), (6, 3, 49, 40, 3)]


def _card_inputs(case, seed):
    bw, h, n, d, p = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((bw, h, n, d), generator=gen, device="cuda") for _ in range(4))
    bias = torch.randn((p, h, n, n), generator=gen, device="cuda")
    return q, k, v, g, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    q, k, v, _, bias = _card_inputs(case, 0)
    before = launches("window_attention_fwd")
    with torch.inference_mode():
        got = window_attention(q, k, v, bias)
        want = window_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert launches("window_attention_fwd") == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_forward_is_deterministic_on_card(case):
    """Every output element has one owning lane and a fixed order of sums:
    two runs of the forward give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    q, k, v, _, bias = _card_inputs(case, 2)
    with torch.inference_mode():
        first = window_attention(q, k, v, bias)
        again = window_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("chunk", [None, 1, 5])
def test_kernel_gradients_match_plain_on_card(case, chunk):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from rgbnomore_tpu_torch.ops.window_attention import window_attention_bwd

    q, k, v, g, bias = _card_inputs(case, 1)
    before = launches("window_attention_bwd")
    got = window_attention_bwd(q, k, v, bias, g, chunk=chunk)
    again = window_attention_bwd(q, k, v, bias, g, chunk=chunk)
    want = window_attention_bwd_plain(q, k, v, bias, g)
    torch.cuda.synchronize()
    assert launches("window_attention_bwd") == before + 4
    for name, a, b, w in zip("qkvb", got, again, want):
        assert torch.equal(a, b), f"d{name} differs between two runs"
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), err_msg=f"d{name}",
                                   **GRAD_TOL)


# ------------------------------------------------ the card: #3L and #4L (N > 64)
# (bw, h, n, d, P): SwinV2-B/w16's 256-token windows with one bias pattern
# (an unshifted block; stage 3's 16 heads too) and with the shift's 4 and 16
# patterns (stages 2 and 1), the bias carrying the -100 shift mask; then
# ragged windows (12x12 under a shift mask, 9x9) and head dims
TILED_CARD_CASES = [(32, 4, 256, 32, 1), (32, 4, 256, 32, 4), (32, 4, 256, 32, 16),
                    (16, 16, 256, 32, 1), (8, 2, 144, 64, 4), (64, 2, 81, 16, 1),
                    (6, 3, 100, 40, 3), (4, 2, 65, 8, 2),
                    # the most registers (D = 64 at N = 256); 50 windows a pattern
                    # in the default chunks of 6, the last one of 2
                    (16, 2, 256, 64, 4), (200, 4, 256, 32, 4)]
# Of the float64 reference's largest entry, per output.  3xTF32 leaves an
# error near float32's own (about 2^-21 of each product, grown over sums of
# up to 256 terms, and over BW / P windows in the bias gradient): measured
# at most 4.4e-6.  Operands rounded once to TF32 (2^-11) read 5.7e-4 or more
# on every output of these cases: the tolerance sits between, 4.5x above
# the one and 28x below the other, and the test checks that the control
# fails it.
TILED_TOL = 2e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tiled_card_inputs(case, seed):
    """q, k, v, dO (bw, h, n, d) and the bias (P, h, n, n): N(0, 1) each,
    the bias plus SwinV2's -100 shift mask where P windows of a square
    n tile a square map."""
    from rgbnomore_tpu_torch.models.swinv2 import _shift_attn_mask

    q, k, v, g, bias = _card_inputs(case, seed)
    _, _, n, _, p = case
    ws, side = round(n ** 0.5), round(p ** 0.5)
    if p > 1 and ws * ws == n and side * side == p:
        mask = _shift_attn_mask(ws * side, ws * side, ws, ws // 2)
        bias = (bias + torch.from_numpy(mask).cuda()[:, None]).contiguous()
    return q, k, v, g, bias


def _float64_attention(q, k, v, bias, g, rounded=False):
    """The plain version and its gradients in float64, on operands rounded
    once to TF32 where ``rounded`` (the bias is kept)."""
    if rounded:
        q, k, v, g = (_tf32(x) for x in (q, k, v, g))
    leaves = [x.double().requires_grad_(True) for x in (q, k, v, bias)]
    with torch.enable_grad():
        out = window_attention_plain(*leaves)
        grads = torch.autograd.grad(out, leaves, g.double())
    return (out.detach(), *grads)


def _of_largest(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILED_CARD_CASES)
def test_tiled_kernels_match_float64_on_card(case):
    """#3L's output and #4L's four gradients against float64 at TILED_TOL of
    the largest entry, which operands rounded once to TF32 fail; two runs of
    each give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from rgbnomore_tpu_torch.ops.window_attention import (window_attention_tiled_bwd,
                                                          window_attention_tiled_fwd)

    q, k, v, g, bias = _tiled_card_inputs(case, 1)
    before = (launches("window_attention_tiled_fwd"), launches("window_attention_tiled_bwd"))
    out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
    got = (out, *window_attention_tiled_bwd(q, k, v, bias, out, lse, g))
    again = (window_attention_tiled_fwd(q, k, v, bias, lse=True)[0],
             *window_attention_tiled_bwd(q, k, v, bias, out, lse, g))
    torch.cuda.synchronize()
    assert (launches("window_attention_tiled_fwd"),
            launches("window_attention_tiled_bwd")) == (before[0] + 2, before[1] + 8)
    want = _float64_attention(q, k, v, bias, g)
    control = _float64_attention(q, k, v, bias, g, rounded=True)
    for name, a, b, w, c in zip(("out", "dq", "dk", "dv", "dbias"), got, again, want, control):
        assert torch.equal(a, b), f"{name} differs between two runs"
        assert _of_largest(a, w) < TILED_TOL, f"{name}: {_of_largest(a, w):.2e}"
        assert _of_largest(c, w) > TILED_TOL, f"the TF32 control passes on {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5])
def test_tiled_bias_gradient_over_chunks_on_card(chunk):
    """The bias gradient summed by blocks of ``chunk`` windows of a pattern
    agrees with the default chunking to float32's round-off; dq, dk, dv do
    not depend on it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from rgbnomore_tpu_torch.ops.window_attention import (window_attention_tiled_bwd,
                                                          window_attention_tiled_fwd)

    q, k, v, g, bias = _tiled_card_inputs((48, 4, 256, 32, 4), 2)
    out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
    base = window_attention_tiled_bwd(q, k, v, bias, out, lse, g)
    other = window_attention_tiled_bwd(q, k, v, bias, out, lse, g, chunk=chunk)
    torch.cuda.synchronize()
    for a, b in zip(base[:3], other[:3]):
        assert torch.equal(a, b)
    assert _of_largest(other[3], base[3].double()) < TILED_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n, small", [(64, True), (256, False)], ids=["64", "256"])
def test_window_attention_routes_by_tokens_on_card(n, small):
    """Through ``window_attention`` with gradients: N = 64 launches #3 once
    and #4 (two kernels), never the tiled pair; N = 256 launches #3L once
    and #4L (four kernels), never #3 or #4."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    names = ("window_attention_fwd", "window_attention_bwd", "window_attention_tiled_fwd",
             "window_attention_tiled_bwd")
    q, k, v, g, bias = _card_inputs((8, 2, n, 32, 1), 3)
    leaves = [x.requires_grad_(True) for x in (q, k, v, bias)]
    before = [launches(name) for name in names]
    window_attention(*leaves).backward(g)
    torch.cuda.synchronize()
    added = [launches(name) - b for name, b in zip(names, before)]
    assert added == ([1, 2, 0, 0] if small else [0, 0, 1, 4])
