"""The port's wire reader against the JAX package's pipelines, on the CPU.

``ops.augpipe.wire_flip_aug_range`` and ``wire_to_range`` read the (B, row)
uint8 rows of the mask16 wire themselves: on the card one launch of the
kernel (``csrc/augpipe.cu``) for the whole train or eval stage, on the CPU
their plain versions (split -> unpack -> flip + RandAugment + ToRange, or
-> ToRange).

- Train: the plain wire path, with the JAX draws (flip and policy,
  re-derived from the key the JAX pipeline splits) handed over, against
  JAX's ``make_cropped_train_pipeline(fused=True)``, which runs the Pallas
  kernel in interpret mode, for mask16, mask16w and mask16q and both preset
  lists, at the Pallas test's 2e-6 on the [-1, 1] output.
- Eval: against JAX's ``make_cropped_eval_pipeline``, bit-exactly.
- Edge blocks packed by hand through JAX's ``unpack_coefficients_mask`` and
  the port's, bit-exactly: an empty mask, the DC bit set (counted in the
  ranks), bit 63, more set bits than K (no slot: 0), scales 0 and 255,
  values -128 and 127, int16 values +-32767.
- The rows are random beyond what the host packer writes
  (``chip_smoke.random_wire_rows``).
- ``Trainer.put_batch`` on the CPU returns the rows themselves.
- ``cuda``-marked tests of the kernel's wire reader against its plain
  version on the card: each op forced, each format, grids 12 and 28, one
  launch a call; the presets; the eval stage and the edge blocks
  bit-exactly; two back-to-back uploads through ``put_batch``'s pinned ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rgbnomore_tpu.augment.pipeline import make_cropped_eval_pipeline as jax_eval_pipeline
from rgbnomore_tpu.augment.pipeline import make_cropped_train_pipeline as jax_train_pipeline
from rgbnomore_tpu.augment.pipeline import unpack_coefficients_mask as jax_unpack
from rgbnomore_tpu.augment.randaugment import RandAugmentDCT as JaxRandAugmentDCT
from rgbnomore_tpu.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI
from rgbnomore_tpu_torch.augment.pipeline import (
    make_cropped_eval_pipeline,
    make_cropped_train_pipeline,
    unpack_coefficients_mask,
)
from rgbnomore_tpu_torch.data.loader import packed_layout
from rgbnomore_tpu_torch.ops.augpipe import (
    SUPPORTED_OPS,
    wire_flip_aug_range,
    wire_flip_aug_range_plain,
    wire_to_range,
    wire_to_range_plain,
)
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer
from torch_port_support import launches

TOL = dict(atol=2e-6, rtol=0)  # the Pallas augmentation test's, on the [-1, 1] output
FORMATS = ["mask16", "mask16w", "mask16q"]
PRESETS = {"vitti": AUGLIST_DCT_VITTI, "dct": AUGLIST_DCT}


def _jax_draws(key, auglist, b, grid):
    """The flip and policy that ``make_cropped_train_pipeline`` draws from
    ``key`` (``pipeline.py:385-389``)."""
    k_flip, k_aug = jax.random.split(key)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    policy = JaxRandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3,
                               grid=grid).draw_policy(k_aug, b, grid, grid)
    return (torch.from_numpy(np.array(flip)),
            tuple(torch.from_numpy(np.array(p)) for p in policy))


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_train_wire_matches_jax(fmt, preset):
    grid, b, k = 12, 4, 16
    auglist = PRESETS[preset]
    rows = chip_smoke.random_wire_rows(np.random.default_rng(FORMATS.index(fmt)), b, grid, k,
                                       fmt)
    key = jax.random.PRNGKey(5)
    want = jax_train_pipeline(target=grid, auglist=list(auglist), num_ops=2, magnitude=3, k=k,
                              fmt=fmt, fused=True, fused_interpret=True)(key, jnp.asarray(rows))
    flip, policy = _jax_draws(key, auglist, b, grid)
    got = wire_flip_aug_range(torch.from_numpy(rows), flip, policy, target=grid, k=k, fmt=fmt,
                              ops_list=list(auglist), num_ops=2, magnitude=3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


def test_train_wire_matches_jax_at_vit_grid():
    """The ViT-Ti grid (28x28) through the train pipelines, each side's
    pipeline object, labels and weights exactly."""
    grid, b, k = 28, 3, 16
    rows = chip_smoke.random_wire_rows(np.random.default_rng(9), b, grid, k)
    kw = dict(target=grid, auglist=list(AUGLIST_DCT_VITTI), num_ops=2, magnitude=3, k=k,
              fmt="mask16")
    key = jax.random.PRNGKey(8)
    want = jax_train_pipeline(**kw, fused=True, fused_interpret=True)(key, jnp.asarray(rows))
    flip, policy = _jax_draws(key, AUGLIST_DCT_VITTI, b, grid)
    got = make_cropped_train_pipeline(**kw)(torch.from_numpy(rows), flip, policy)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grid", [12, 28])
@pytest.mark.parametrize("fmt", FORMATS)
def test_eval_wire_bit_exact(fmt, grid):
    rows = chip_smoke.random_wire_rows(np.random.default_rng(grid), 3, grid, 48, fmt)
    want = jax_eval_pipeline(target=grid, k=48, fmt=fmt)(jnp.asarray(rows))
    got = wire_to_range(torch.from_numpy(rows), target=grid, k=48, fmt=fmt)
    for g, w in zip(got, want[:2]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pipe = make_cropped_eval_pipeline(target=grid, k=48, fmt=fmt)(torch.from_numpy(rows))
    for g, w in zip(pipe, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _block(k, bits, values=(), scale=1, dtype=np.int8):
    """One packed block: ``values`` in the first slots of K, the mask with
    ``bits`` set, the scale."""
    v = np.zeros(k, dtype)
    v[:len(values)] = values
    mask = np.zeros(64, bool)
    mask[list(bits)] = True
    return v, np.packbits(mask.reshape(8, 8), axis=-1, bitorder="little")[:, 0], np.uint8(scale)


EDGE_BLOCKS = {
    "empty_mask": (4, (), (5, 6, 7, 8), 3, np.int8),
    "dc_bit_counted": (4, (0, 1, 2), (9, 10, 11, 12), 2, np.int8),
    "bit_63": (4, (5, 63), (-3, 7), 1, np.int8),
    "more_bits_than_k": (4, (1, 2, 3, 4, 5), (1, 2, 3, 4), 1, np.int8),
    "all_bits_k16": (16, range(64), range(-8, 8), 5, np.int8),
    "scale_0": (4, (1, 9), (100, -100), 0, np.int8),
    "scale_255": (4, (1, 9, 40), (127, -128, 1), 255, np.int8),
    "int8_extremes": (4, (2, 3), (-128, 127), 7, np.int8),
    "int16_extremes": (4, (1, 62), (32767, -32767), 1, np.int16),
    "int16_more_bits": (2, (1, 2, 3), (-32767, 32767), 1, np.int16),
}


def _edge_arrays(name):
    k, bits, values, scale, dtype = EDGE_BLOCKS[name]
    v, m, s = _block(k, bits, values, scale, dtype)
    return v[None], m[None], np.asarray([s])


@pytest.mark.parametrize("name", sorted(EDGE_BLOCKS))
def test_edge_blocks_unpack_like_jax(name):
    v, m, s = _edge_arrays(name)
    want = np.asarray(jax_unpack(jnp.asarray(v), jnp.asarray(m), jnp.asarray(s)))
    got = unpack_coefficients_mask(*(torch.from_numpy(a) for a in (v, m, s))).numpy()
    np.testing.assert_array_equal(got, want)


def test_more_bits_than_k_reads_zero():
    """K=4 and bits 1-5 set: the fifth set bit has no slot and reads 0."""
    v, m, s = _edge_arrays("more_bits_than_k")
    got = unpack_coefficients_mask(*(torch.from_numpy(a) for a in (v, m, s)))
    np.testing.assert_array_equal(got.numpy().reshape(64)[:8], [0, 1, 2, 3, 4, 0, 0, 0])


def _edge_rows(fmt, k=4, grid=4):
    """Rows of a 4x4 grid whose first blocks hold every edge block of the
    format's value type (their K padded to ``k``), random beyond."""
    rows = chip_smoke.random_wire_rows(np.random.default_rng(2), 2, grid, k, fmt)
    lay = packed_layout(grid, k, fmt)
    wide = fmt == "mask16w"
    names = [n for n, e in EDGE_BLOCKS.items() if (e[4] == np.int16) == wide and e[0] <= k]
    for tag, blocks in (("y", grid * grid), ("c", 2 * (grid // 2) ** 2)):
        for i, name in enumerate(names[:blocks]):
            kk, bits, values, scale, dtype = EDGE_BLOCKS[name]
            v, m, s = _block(k, bits, values[:kk], scale, dtype)
            for field, val in ((f"v{tag}", v), (f"i{tag}", m), (f"s{tag}", np.asarray([s]))):
                off, shape, dt = lay[field]
                per = int(np.prod(shape[-1:])) * dt.itemsize if field[0] != "s" else 1
                rows[0, off + i * per:off + (i + 1) * per] = val.view(np.uint8)
    return rows


@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_rows_through_eval_like_jax(fmt):
    rows = _edge_rows(fmt)
    want = jax_eval_pipeline(target=4, k=4, fmt=fmt)(jnp.asarray(rows))
    got = wire_to_range(torch.from_numpy(rows), target=4, k=4, fmt=fmt)
    for g, w in zip(got, want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_buffers_launch_no_kernel():
    rows = torch.from_numpy(chip_smoke.random_wire_rows(np.random.default_rng(3), 2, 8, 16))
    flip = torch.tensor([True, False])
    policy = (torch.zeros((2, 1), dtype=torch.int32), torch.ones((2, 1)),
              torch.zeros((2, 1), dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int32),
              torch.zeros((2, 1), dtype=torch.bool))
    kernels = ("wire_flip_aug_range", "wire_to_range", "fused_flip_aug_range")
    counts = [launches(k) for k in kernels]
    got = wire_flip_aug_range(rows, flip, policy, target=8, k=16, fmt="mask16",
                              ops_list=["Identity"], num_ops=1, magnitude=3)
    want = wire_flip_aug_range_plain(rows, flip, policy, target=8, k=16, fmt="mask16",
                                     ops_list=["Identity"], num_ops=1, magnitude=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = wire_to_range(rows, target=8, k=16, fmt="mask16")
    want = wire_to_range_plain(rows, target=8, k=16, fmt="mask16")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts == [launches(k) for k in kernels]


def test_wire_refuses_bad_rows():
    rows = torch.zeros((2, packed_layout(8, 16)["row"] + 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="layout wants"):
        wire_to_range(rows, target=8, k=16, fmt="mask16")
    with pytest.raises(ValueError, match="wire reader takes"):
        wire_to_range(rows, target=8, k=16, fmt="mask")


def test_put_batch_on_cpu_returns_the_rows():
    rows = chip_smoke.random_wire_rows(np.random.default_rng(4), 3, 8, 16)
    cfg = generate_config("vitti", "dct", modelver=1)
    cfg.model.depth = 1
    got = Trainer(cfg, device="cpu").put_batch({"packed": rows})["packed"]
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), rows)


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _forced_policy():
    """The explicit policy and flip of tests/test_pallas_augpipe.py:62-68."""
    return ((torch.zeros((3, 1), dtype=torch.int32), torch.tensor([[1.0], [-1.0], [1.0]]),
             torch.tensor([[4], [0], [10]], dtype=torch.int32),
             torch.tensor([[6], [2], [0]], dtype=torch.int32),
             torch.tensor([[True], [False], [True]])),
            torch.tensor([False, True, False]))


def _held_on_card(rows, flip, policy, **kw):
    packed = torch.from_numpy(rows).cuda()
    before = launches("wire_flip_aug_range")
    got = wire_flip_aug_range(packed, flip, policy, **kw)
    torch.cuda.synchronize()
    assert launches("wire_flip_aug_range") == before + 1
    want = wire_flip_aug_range_plain(packed, flip, policy, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [12, 28])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(SUPPORTED_OPS))
def test_wire_kernel_each_op_on_card(name, fmt, grid):
    _card()
    rows = chip_smoke.random_wire_rows(np.random.default_rng(grid), 3, grid, 16, fmt)
    policy, flip = _forced_policy()
    _held_on_card(rows, flip, policy, target=grid, k=16, fmt=fmt, ops_list=[name], num_ops=1,
                  magnitude=5)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_kernel_presets_on_card(fmt, preset):
    _card()
    auglist = PRESETS[preset]
    pipe = make_cropped_train_pipeline(target=28, auglist=list(auglist), num_ops=2,
                                       magnitude=3, k=16, fmt=fmt)
    flip, policy, _ = pipe.draw(torch.Generator().manual_seed(1), 64)
    rows = chip_smoke.random_wire_rows(np.random.default_rng(5), 64, 28, 16, fmt)
    _held_on_card(rows, flip, policy, target=28, k=16, fmt=fmt, ops_list=list(auglist),
                  num_ops=2, magnitude=3)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [12, 28])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_kernel_eval_bit_exact_on_card(fmt, grid):
    _card()
    rows = chip_smoke.random_wire_rows(np.random.default_rng(6), 16, grid, 48, fmt)
    before = launches("wire_to_range")
    got = wire_to_range(torch.from_numpy(rows).cuda(), target=grid, k=48, fmt=fmt)
    torch.cuda.synchronize()
    assert launches("wire_to_range") == before + 1
    want = wire_to_range_plain(torch.from_numpy(rows), target=grid, k=48, fmt=fmt)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_kernel_edge_rows_on_card(fmt):
    _card()
    rows = _edge_rows(fmt)
    got = wire_to_range(torch.from_numpy(rows).cuda(), target=4, k=4, fmt=fmt)
    want = wire_to_range_plain(torch.from_numpy(rows), target=4, k=4, fmt=fmt)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_put_batch_back_to_back_on_card():
    """Three uploads of one shape through the ring of two pinned buffers:
    the first under ``torch.inference_mode`` (as ``Trainer.evaluate`` runs),
    the third reusing the first's buffer outside it; each arrives intact."""
    _card()
    cfg = generate_config("vitti", "dct", modelver=1)
    cfg.model.depth = 1
    trainer = Trainer(cfg, device="cuda")
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (64, 4096), dtype=np.uint8) for _ in range(3)]
    with torch.inference_mode():
        got = [trainer.put_batch({"packed": batches[0]})["packed"]]
    got += [trainer.put_batch({"packed": rows})["packed"] for rows in batches[1:]]
    torch.cuda.synchronize()
    for g, rows in zip(got, batches):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), rows)
