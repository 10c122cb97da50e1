"""The DCT RandAugment ops outside the fused kernel's set, and their routing,
against the JAX package's, on the CPU.

- ``invert_dct``, ``solarize_dct`` (its mask), ``equalize_dct`` (the 2,041
  DC bins, per sample and channel) and ``freq_enhance_dct`` exactly.
- ``RandAugmentDCT`` with each op of the 23-op table forced, and with the
  whole table as its list, on JAX's draws: the coefficients after the
  rounds at 1e-2, the geometry tests' tolerance (Rotate and Shear run
  through the global DFT; every other op agrees to float32 rounding).
- The routing: a list inside the kernel's op set runs the train stage as
  one ``wire_flip_aug_range`` (the cropped wire) or ``fused_flip_aug_range``
  (the full canvas) a step; a list with Rotate, Shear, Equalize, Solarize,
  Invert or FreqEnhance runs none of them, and the plain sequence instead,
  counted through the wrappers.  The cropped train pipeline on the seven
  ops against JAX's XLA pipeline with its draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbnomore_tpu.augment.pipeline import make_cropped_train_pipeline as jax_train_pipeline
from rgbnomore_tpu.augment.randaugment import RandAugmentDCT as JaxRandAugmentDCT
from rgbnomore_tpu.augment.randaugment import _magnitude_table as jax_table
from rgbnomore_tpu.ops import photometric as jph
from rgbnomore_tpu.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI
from rgbnomore_tpu_torch.augment import pipeline
from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
from rgbnomore_tpu_torch.ops import photometric as ph

from torch_port_support import write_rows

SEVEN = ["Rotate", "ShearX", "ShearY", "Equalize", "Solarize", "Invert", "FreqEnhance"]
TABLE = sorted(jax_table(11, 8, 8))
ATOL = 1e-2  # tests/test_ops_geometry.py's, on coefficients in [-1024, 1016]


def _coeffs(seed, b=4, h=8, w=8):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1100, 1100, (b, 1, h, w, 8, 8)).astype(np.float32)
    c = rng.uniform(-1100, 1100, (b, 2, h // 2, w // 2, 8, 8)).astype(np.float32)
    return y, c


def test_table_has_23_ops_and_all_build():
    assert len(TABLE) == 23
    aug = RandAugmentDCT(ops_list=TABLE, grid=8)
    assert len(aug._ops) == 23


def test_photometric_ops_match_jax():
    y, _ = _coeffs(0)
    y[:, :, :4, :4, 0, 0] = np.round(y[:, :, :4, :4, 0, 0] / 64) * 64  # shared DC bins
    t = torch.from_numpy(y)
    np.testing.assert_array_equal(ph.equalize_dct(t).numpy(),
                                  np.asarray(jax.vmap(jph.equalize_dct)(y)))
    np.testing.assert_array_equal(ph.invert_dct(t).numpy(), np.asarray(jph.invert_dct(y)))
    got, mask = ph.solarize_dct(t, 100.0)
    want, jmask = jph.solarize_dct(y, 100.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    factor = np.asarray([1.5, 0.1, 1.9, 1.0], np.float32)
    want = jax.vmap(jph.freq_enhance_dct)(y, factor)
    np.testing.assert_array_equal(ph.freq_enhance_dct(t, torch.from_numpy(factor)).numpy(),
                                  np.asarray(want))


def _both(ops, y, c, key, magnitude=7):
    jaug = JaxRandAugmentDCT(ops_list=ops, num_ops=2, magnitude=magnitude, grid=y.shape[2])
    policy = jaug.draw_policy(key, y.shape[0], y.shape[2], y.shape[3])
    jy, jc = jax.jit(lambda k, a, b: jaug(k, a, b))(key, jnp.asarray(y), jnp.asarray(c))
    aug = RandAugmentDCT(ops_list=ops, num_ops=2, magnitude=magnitude, grid=y.shape[2])
    ty, tc = aug.apply(torch.from_numpy(y), torch.from_numpy(c),
                       tuple(torch.from_numpy(np.array(p)) for p in policy))
    return (ty, tc), (jy, jc), policy


@pytest.mark.parametrize("name", SEVEN)
def test_each_new_op_matches_jax(name):
    """The op forced in both rounds (a one-op list), both signs drawn."""
    y, c = _coeffs(SEVEN.index(name))
    got, want, policy = _both([name], y, c, jax.random.PRNGKey(SEVEN.index(name)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    if name in ("Rotate", "ShearX", "ShearY", "FreqEnhance"):
        assert set(np.unique(np.asarray(policy[1]))) == {-1.0, 1.0}


def test_whole_table_matches_jax():
    y, c = _coeffs(30, b=16)
    got, want, policy = _both(TABLE, y, c, jax.random.PRNGKey(3))
    assert len(np.unique(np.asarray(policy[0]))) >= 12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


class _Counted:
    """Counts the calls of a pipeline stage, then calls it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("ops,fused", [
    (AUGLIST_DCT_VITTI, True), (AUGLIST_DCT, True), (["Identity"], True),
    *[(["Brightness", op], False) for op in SEVEN],
], ids=["vitti", "dct", "identity", *SEVEN])
def test_routing_from_the_op_list(monkeypatch, ops, fused):
    """The stage is chosen from the op list when the pipeline is built: the
    preset lists run the wire reader's wrapper once a step, a list with an
    op outside the kernel's set runs it never."""
    grid, b, k = 8, 4, 16
    wire = _Counted(pipeline.wire_flip_aug_range)
    plain = _Counted(pipeline.wire_flip_aug_range_plain)
    monkeypatch.setattr(pipeline, "wire_flip_aug_range", wire)
    monkeypatch.setattr(pipeline, "wire_flip_aug_range_plain", plain)
    pipe = pipeline.make_cropped_train_pipeline(target=grid, auglist=list(ops), k=k)
    assert pipe.fused is fused
    rows = write_rows(*_coeffs(1, b, grid, grid), np.arange(b, dtype=np.int32), k)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        y, c, labels, _ = pipe(torch.from_numpy(rows), *pipe.draw(gen, b))
        assert y.shape == (b, 1, grid, grid, 8, 8) and bool(torch.isfinite(y).all())
    assert (wire.calls, plain.calls) == ((3, 0) if fused else (0, 3))

    dense = _Counted(pipeline.fused_flip_aug_range)
    monkeypatch.setattr(pipeline, "fused_flip_aug_range", dense)
    full = pipeline.make_train_pipeline(target=grid, canvas=16, auglist=list(ops))
    assert full.fused is fused
    yq = np.random.default_rng(2).integers(-20, 20, (b, 1, 16, 16, 8, 8)).astype(np.int16)
    cq = np.random.default_rng(3).integers(-20, 20, (b, 2, 8, 8, 8, 8)).astype(np.int16)
    inputs = {"y": torch.from_numpy(yq), "cbcr": torch.from_numpy(cq),
              "quant": torch.ones((b, 3, 8, 8), dtype=torch.int16),
              "labels": torch.zeros(b, dtype=torch.int32), "weights": torch.ones(b)}
    full(inputs, *full.draw(gen, b))
    assert dense.calls == (1 if fused else 0)


def test_cropped_pipeline_on_the_seven_ops_matches_jax():
    """``make_cropped_train_pipeline`` with the seven ops against JAX's XLA
    pipeline, JAX's flip and policy handed over (``pipeline.py:384-389``)."""
    grid, b, k = 8, 6, 16
    y, c = _coeffs(5, b, grid, grid)
    rows = write_rows(y, c, np.arange(b, dtype=np.int32), k)
    key = jax.random.PRNGKey(9)
    jpipe = jax_train_pipeline(target=grid, auglist=SEVEN, num_ops=2, magnitude=7, k=k,
                               fused=False)
    jy, jc, jl, jw = jpipe(key, jnp.asarray(rows))
    k_flip, k_aug = jax.random.split(key)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    jaug = JaxRandAugmentDCT(ops_list=SEVEN, num_ops=2, magnitude=7, grid=grid)
    policy = jaug.draw_policy(k_aug, b, grid, grid)
    pipe = pipeline.make_cropped_train_pipeline(target=grid, auglist=SEVEN, num_ops=2,
                                                magnitude=7, k=k)
    assert not pipe.fused
    ty, tc, tl, tw = pipe(torch.from_numpy(rows), torch.from_numpy(np.array(flip)),
                          tuple(torch.from_numpy(np.array(p)) for p in policy))
    # 1e-2 on coefficients is 1e-5 on the [-1, 1] output (range 2040 -> 2)
    for g, w in ((ty, jy), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL / 1020, rtol=0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
