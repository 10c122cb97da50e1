"""The port's attention against the JAX package's Pallas kernel.

``attention_plain`` and the CPU path of ``fused_attention`` are held against
``rgbnomore_tpu.ops.pallas.attention.fused_attention`` in interpret mode, on
the same numpy inputs, at the Pallas test's tolerances: atol 2e-5, rtol
1e-4 forward (``tests/test_pallas_attention.py:21-30``); gradients through
autograd against ``jax.grad`` through the Pallas VJP at atol 5e-4, rtol
1e-3 (``:33-50``).  The CUDA kernels themselves run only on a card: the
tests marked ``cuda``.
"""

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
)

SHAPES = [(196, 64), (49, 32), (128, 128)]
SCALE = 1.0 / 192**0.5


def _inputs(rng, n, d, b=2, h=3):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fn", [attention_plain, fused_attention],
                         ids=["plain", "fused_cpu"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_matches_pallas_kernel(rng, n, d, fn):
    q, k, v = _inputs(rng, n, d)
    want = np.asarray(pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       SCALE, True))
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), SCALE)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_cpu_path_launches_no_kernel(rng):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 16, 8))
    before = launches("fused_attention_fwd")
    fused_attention(q, k, v, SCALE)
    assert launches("fused_attention_fwd") == before


def _grad_inputs(rng, b, h, n, d):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4)]


# the Pallas test's shape and scale, and a ViT-Ti head (scale 1/sqrt(192))
@pytest.mark.parametrize("shape,scale", [((1, 2, 52, 24), 0.13), ((2, 3, 196, 64), SCALE)],
                         ids=["pallas_test", "vitti_head"])
def test_gradients_match_pallas_vjp(rng, shape, scale):
    """Gradients of sum((attention - t)^2) through the port's autograd
    Function against jax.grad through the Pallas kernel's custom VJP."""
    q, k, v, t = _grad_inputs(rng, *shape)

    def loss(q, k, v):
        return jnp.sum((pallas_attention(q, k, v, scale, True) - jnp.asarray(t)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ((fused_attention(*leaves, scale) - torch.from_numpy(t)) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3)


def test_cpu_backward_is_autograd_through_plain(rng):
    q, k, v, g = (torch.from_numpy(a) for a in _grad_inputs(rng, 2, 3, 20, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention(*leaves, SCALE).backward(g)
    for leaf, w in zip(leaves, attention_bwd_plain(q, k, v, g, SCALE)):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("bad, error", [
    (lambda q: q[0], ValueError),                        # rank 3
    (lambda q: q.double(), TypeError),                   # float64
    (lambda q: q.half(), TypeError),                     # float16
    (lambda q: q[..., :4], ValueError),                  # shape differs from k, v
    (lambda q: q.transpose(2, 3).contiguous().transpose(2, 3), ValueError),  # strided
], ids=["rank", "float64", "float16", "shape", "noncontiguous"])
def test_refuses_bad_inputs(rng, bad, error):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 16, 8))
    with pytest.raises(error):
        fused_attention(bad(q), k, v, SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(256, 196, 64), (2, 49, 32), (2, 128, 128), (1, 52, 24)])
def test_kernel_matches_plain_on_card(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, 3, n, d), generator=gen, device="cuda") for _ in range(3))
    before = launches("fused_attention_fwd")
    with torch.inference_mode():
        got = fused_attention(q, k, v, SCALE)
        want = attention_plain(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert launches("fused_attention_fwd") == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(256, 196, 64), (1, 52, 24), (2, 49, 32), (2, 128, 128)])
def test_kernel_gradients_match_plain_on_card(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g = (torch.randn((b, 3, n, d), generator=gen, device="cuda") for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = launches("fused_attention_bwd")
    fused_attention(*leaves, SCALE).backward(g)
    torch.cuda.synchronize()
    assert launches("fused_attention_bwd") == before + 1
    for leaf, w in zip(leaves, attention_bwd_plain(q, k, v, g, SCALE)):
        np.testing.assert_allclose(leaf.grad.cpu().numpy(), w.cpu().numpy(), atol=5e-4,
                                   rtol=1e-3)


@pytest.mark.cuda
def test_kernel_backward_is_deterministic_on_card():
    """The backward kernel sums in a fixed order, with no atomics: two runs
    at the ViT-Ti shape give bit-identical dq, dk, dv."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from rgbnomore_tpu_torch.ops.attention import fused_attention_bwd, fused_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (torch.randn((256, 3, 196, 64), generator=gen, device="cuda") for _ in range(4))
    out, lse = fused_attention_fwd(q, k, v, SCALE, with_lse=True)
    first = fused_attention_bwd(q, k, v, out, lse, g, SCALE)
    again = fused_attention_bwd(q, k, v, out, lse, g, SCALE)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
