"""The port's train input stage against the JAX package's, on the CPU.

- Each of the 16 ops of the fused kernel's op set, with the explicit policy
  and flip of ``tests/test_pallas_augpipe.py:56-76``: the port's
  ``fused_flip_aug_range`` (its plain path on CPU tensors) against JAX's
  ``fused_flip_aug_range(interpret=True)`` and against the XLA switch path
  (``_ref_apply``), at the Pallas test's 2e-6 on the [-1, 1] output.
- Both presets with JAX-drawn policies.
- The port's ``make_cropped_train_pipeline`` against JAX's
  ``make_cropped_train_pipeline(fused=False)`` on the same K=16 rows with
  the JAX flip and policy handed over: y and c at 2e-6, labels and weights
  exactly.
- Properties of the port's own ``draw_policy``.
- A ``cuda``-marked test of the kernel against the plain version on the
  card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.augment.pipeline import make_cropped_train_pipeline as jax_train_pipeline
from rgbnomore_tpu.augment.randaugment import RandAugmentDCT as JaxRandAugmentDCT
from rgbnomore_tpu.ops.pallas.augpipe import SUPPORTED_OPS as JAX_SUPPORTED_OPS
from rgbnomore_tpu.ops.pallas.augpipe import fused_flip_aug_range as jax_fused
from rgbnomore_tpu.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI
from torch_port_support import launches
from rgbnomore_tpu_torch.augment.pipeline import make_cropped_train_pipeline
from rgbnomore_tpu_torch.augment.randaugment import CHROMA_OPS, RandAugmentDCT
from rgbnomore_tpu_torch.ops import augpipe
from rgbnomore_tpu_torch.ops.augpipe import (
    SUPPORTED_OPS,
    flip_aug_range_plain,
    fused_flip_aug_range,
)
from test_pallas_augpipe import _ref_apply

import chip_smoke

TOL = dict(atol=2e-6, rtol=0)  # the Pallas test's, on the [-1, 1] output


def _coeffs(seed, b=3, h=12, w=12):
    """y, c uniform in [-1100, 1100] (beyond the clamp range), from numpy."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1100, 1100, (b, 1, h, w, 8, 8)).astype(np.float32)
    c = rng.uniform(-1100, 1100, (b, 2, h // 2, w // 2, 8, 8)).astype(np.float32)
    return y, c


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _forced_policy(b=3):
    """The explicit policy and flip of test_pallas_augpipe.py:62-68."""
    idx = np.zeros((b, 1), np.int32)
    sign = np.asarray([[1.0], [-1.0], [1.0]], np.float32)[:b]
    ch = np.asarray([[4], [0], [10]], np.int32)[:b]
    cw = np.asarray([[6], [2], [0]], np.int32)[:b]
    drop = np.asarray([[1], [0], [1]], np.int32)[:b]
    flip = np.asarray([False, True, False])[:b]
    return (idx, sign, ch, cw, drop), flip


def test_op_set_matches_jax():
    assert SUPPORTED_OPS == JAX_SUPPORTED_OPS


@pytest.mark.parametrize("name", sorted(JAX_SUPPORTED_OPS))
def test_each_op_matches_jax(name):
    y, c = _coeffs(sorted(JAX_SUPPORTED_OPS).index(name))
    policy, flip = _forced_policy()
    kw = dict(ops_list=[name], num_ops=1, magnitude=5)
    jy, jc = jax_fused(jnp.asarray(y), jnp.asarray(c), tuple(map(jnp.asarray, policy)),
                       jnp.asarray(flip), interpret=True, **kw)
    aug = JaxRandAugmentDCT(ops_list=[name], num_ops=1, magnitude=5, grid=12)
    ry, rc = _ref_apply(aug, tuple(map(jnp.asarray, policy)), jnp.asarray(flip),
                        jnp.asarray(y), jnp.asarray(c))
    gy, gc = fused_flip_aug_range(*_torch(y, c), tuple(_torch(*policy)),
                                  torch.from_numpy(flip), **kw)
    for got, want in ((gy, jy), (gc, jc), (gy, ry), (gc, rc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_draws(auglist, b, grid, seed):
    aug = JaxRandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=grid)
    k_pol, k_flip = jax.random.split(jax.random.PRNGKey(seed))
    policy = aug.draw_policy(k_pol, b, grid, grid)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    return aug, policy, flip


@pytest.mark.parametrize("auglist", [AUGLIST_DCT_VITTI, AUGLIST_DCT], ids=["vitti", "dct"])
def test_presets_with_jax_policy(auglist):
    y, c = _coeffs(7, b=6)
    aug, policy, flip = _jax_draws(auglist, 6, 12, 11)
    kw = dict(ops_list=list(auglist), num_ops=2, magnitude=3)
    jy, jc = jax_fused(jnp.asarray(y), jnp.asarray(c), policy, flip, interpret=True, **kw)
    gy, gc = fused_flip_aug_range(*_torch(y, c), tuple(_torch(*policy)),
                                  torch.from_numpy(np.array(flip)), **kw)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(jc), **TOL)


def test_train_pipeline_matches_jax(rng):
    """The same K=16 rows through both pipelines, with the JAX draws (flip
    and policy, re-derived from the key the JAX pipeline splits) handed to
    the port."""
    grid, b = 8, 4
    y, c = chip_smoke.synthetic_planes(rng, b, grid)
    labels = np.arange(b, dtype=np.int32) * 3
    rows = chip_smoke.write_rows(y, c, labels, 16)
    kw = dict(target=grid, auglist=list(AUGLIST_DCT_VITTI), num_ops=2, magnitude=3, k=16,
              fmt="mask16")
    key = jax.random.PRNGKey(3)
    want = jax_train_pipeline(**kw, fused=False)(key, jnp.asarray(rows))
    k_flip, k_aug = jax.random.split(key)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    policy = JaxRandAugmentDCT(ops_list=list(AUGLIST_DCT_VITTI), num_ops=2, magnitude=3,
                               grid=grid).draw_policy(k_aug, b, grid, grid)
    pipe = make_cropped_train_pipeline(**kw)
    got = pipe(torch.from_numpy(rows), torch.from_numpy(np.array(flip)),
               tuple(_torch(*policy)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _draw(auglist, batch=4096, grid=28, seed=0):
    aug = RandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=grid)
    gen = torch.Generator().manual_seed(seed)
    return aug, aug.draw_policy(gen, batch, grid, grid)


def test_draw_policy_exclusion_rule():
    """Grayscale and a chroma op never share a sample, whatever the order."""
    aug, (idx, *_rest) = _draw(AUGLIST_DCT_VITTI)
    names = np.asarray(AUGLIST_DCT_VITTI)[idx.numpy()]
    gray = (names == "Grayscale").any(axis=1)
    chroma = np.isin(names, sorted(CHROMA_OPS - {"Grayscale"})).any(axis=1)
    assert gray.any() and chroma.any()
    assert not (gray & chroma).any()


def test_draw_policy_signs_and_centres():
    aug, (idx, sign, ch, cw, drop) = _draw(AUGLIST_DCT)
    signed = np.asarray([aug._signed[i].item() for i in range(len(AUGLIST_DCT))])
    neg = sign.numpy() < 0
    assert neg.any() and signed[idx.numpy()[neg]].all()
    assert set(np.unique(sign.numpy())) <= {-1.0, 1.0}
    for centre in (ch.numpy(), cw.numpy()):
        assert (centre % 2 == 0).all() and centre.min() >= 0 and centre.max() < 28
    assert idx.dtype == torch.int32 and drop.dtype == torch.bool
    assert 0.4 < drop.float().mean() < 0.6


def test_draw_policy_reopens_an_emptied_list():
    """An all-chroma list: Grayscale then forbids every other op and a
    chroma op forbids Grayscale; the emptied list is reopened."""
    ops = ["Grayscale", "Color"]
    aug, (idx, *_rest) = _draw(ops, batch=512)
    assert idx.shape == (512, 2)
    idx = idx.numpy()
    # after Grayscale the list is empty (Color is chroma) and reopens, so
    # both ops follow it; after Color only Color is left
    after_gray = idx[idx[:, 0] == 0, 1]
    assert set(np.unique(after_gray)) == {0, 1}
    assert (idx[idx[:, 0] == 1, 1] == 1).all()


def test_draw_policy_is_seeded():
    _, a = _draw(AUGLIST_DCT_VITTI, batch=64, seed=5)
    _, b = _draw(AUGLIST_DCT_VITTI, batch=64, seed=5)
    for x, z in zip(a, b):
        assert torch.equal(x, z)


def test_unported_ops_raise():
    """The ops outside the kernel's set are ported: ``RandAugmentDCT`` takes
    Equalize and runs it (the test of its values against JAX's is
    ``tests/test_torch_port_dct_ops.py``); the kernel's op table still
    refuses Solarize, so such a list takes the plain path."""
    aug = RandAugmentDCT(ops_list=["Equalize"], num_ops=1, grid=12)
    y, c = _torch(*_coeffs(2))
    policy = aug.draw_policy(torch.Generator().manual_seed(0), 3, 12, 12)
    gy, gc = aug.apply(y, c, policy)
    assert torch.equal(gc, torch.clamp(c, -1024, 1016))  # luma only
    assert not torch.equal(gy[..., 0, 0], torch.clamp(y, -1024, 1016)[..., 0, 0])
    with pytest.raises(ValueError, match="does not support"):
        augpipe.op_tables(["Solarize"], 3, 11, 28, 28)


def test_cpu_path_launches_no_kernel():
    y, c = _coeffs(1)
    policy, flip = _forced_policy()
    before = launches("fused_flip_aug_range")
    fused_flip_aug_range(*_torch(y, c), tuple(_torch(*policy)), torch.from_numpy(flip),
                         ops_list=["Identity"], num_ops=1, magnitude=3)
    assert launches("fused_flip_aug_range") == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JAX_SUPPORTED_OPS))
def test_kernel_each_op_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    y, c = (torch.from_numpy(a).cuda() for a in _coeffs(4))
    policy, flip = _forced_policy()
    policy, flip = tuple(_torch(*policy)), torch.from_numpy(flip)
    kw = dict(ops_list=[name], num_ops=1, magnitude=5)
    gy, gc = fused_flip_aug_range(y, c, policy, flip, **kw)
    wy, wc = flip_aug_range_plain(y, c, policy, flip, **kw)
    np.testing.assert_allclose(gy.cpu().numpy(), wy.cpu().numpy(), **TOL)
    np.testing.assert_allclose(gc.cpu().numpy(), wc.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("auglist", [AUGLIST_DCT_VITTI, AUGLIST_DCT], ids=["vitti", "dct"])
def test_kernel_matches_plain_on_card(auglist):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    aug = RandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=28)
    gen = torch.Generator().manual_seed(0)
    policy = aug.draw_policy(gen, 64, 28, 28)
    flip = torch.rand(64, generator=gen) < 0.5
    y, c = (torch.from_numpy(a).cuda() for a in _coeffs(2, b=64, h=28, w=28))
    kw = dict(ops_list=list(auglist), num_ops=2, magnitude=3)
    before = launches("fused_flip_aug_range")
    gy, gc = fused_flip_aug_range(y, c, policy, flip, **kw)
    torch.cuda.synchronize()
    assert launches("fused_flip_aug_range") == before + 1
    wy, wc = flip_aug_range_plain(y, c, policy, flip, **kw)
    np.testing.assert_allclose(gy.cpu().numpy(), wy.cpu().numpy(), **TOL)
    np.testing.assert_allclose(gc.cpu().numpy(), wc.cpu().numpy(), **TOL)
