"""Support shared by the port's tests (``tests/test_torch_port_*.py``) and
the card check ``chip_smoke.py``: the seeded wire rows, the reference-named
state dicts, ILSVRC-shaped tars, the readers of a trace's port spans and of
ptxas's kernel names, and the JAX side of the lockstep tests (whose JAX
imports stay inside the functions)."""

import collections
import contextlib
import inspect
import math
import re
import sys

import numpy as np


def settle_inspect_module_walk() -> None:
    """Take this process's first walk of ``inspect.getmodule`` over
    ``sys.modules`` now, where its fault is harmless.

    ``tests/test_torch_import.py`` installs a torchvision stub whose module
    ``__getattr__`` answers ``__file__`` with a function.  The first walk in
    a process that meets it raises ``AttributeError``; inspect has cached
    the stub's entry by then, so every later walk skips it.  torch walks
    when it first imports ``torch._dynamo``, which the first
    ``torch.optim`` optimizer in the process does.  Call this before a test
    builds one, so that the outcome does not hang on which test files ran
    earlier in the same process.
    """
    try:
        inspect.getmodule(sys._getframe(), "<settle>")
    except AttributeError:
        pass


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on a float32 tensor: round to nearest with ties
    away from zero, keeping 10 mantissa bits, by adding half of the 13
    dropped bits' unit to the bit pattern and zeroing the low 13 bits (the
    sign bit stays apart from the magnitude, so negatives round the same
    way)."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """What the tensor core reads of a float32 register as TF32: the low
    13 bits dropped."""
    import torch

    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as the port's 3xTF32 kernels compute it (``csrc/
    tf32_mma.cuh``): the cross terms, then hi x hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_read(a - a_hi), tf32_read(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def mm_1xtf32(a, b):
    """``a @ b`` in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def jax_rgb_policy(aug, key, batch):
    """The draws that the JAX ``RandAugmentRGB(key, img)`` makes inside its
    ops (``augment/rgb.py:349-376``), as the port's ``draw_policy`` tuple
    ``(idx, sign, cut_ch, cut_cw, drop)`` of (batch, num_ops) numpy arrays:
    one key a sample, each round split in four (the next key, the op, the
    sign, the op's own key); Cutout splits the op's key into its row and
    column keys, ChromaDrop draws its bit from the op's key."""
    import jax
    import jax.numpy as jnp

    n = len(aug.ops_list)
    h, w = aug.image_hw
    signed = jnp.asarray(aug._signed)

    def rounds(rng):
        def body(rng, _):
            rng, k_op, k_sign, k_inner = jax.random.split(rng, 4)
            idx = jax.random.randint(k_op, (), 0, n)
            sign = jnp.where(jax.random.bernoulli(k_sign) & (signed[idx] > 0), -1.0, 1.0)
            kh, kw = jax.random.split(k_inner)
            return rng, (idx, sign, jax.random.randint(kh, (), 0, h),
                         jax.random.randint(kw, (), 0, w), jax.random.bernoulli(k_inner))

        return jax.lax.scan(body, rng, None, length=aug.num_ops)[1]

    outs = jax.vmap(rounds)(jax.random.split(key, batch))
    dtypes = (np.int32, np.float32, np.int32, np.int32, np.bool_)
    return tuple(np.asarray(o).astype(dt) for o, dt in zip(outs, dtypes))


def jax_step_draws(trainer, base_rng, step, batch, grid):
    """The draws of the JAX Trainer's step ``step`` (``loop.py:247-263``,
    ``pipeline.py:399-404``; RGB: ``pipeline.py:208-212``) as the port's
    ``StepDraws``: fold the step into the base key, split it in three
    (augment, mixup, dropout), split the augment key in two (flip, policy).
    The dropout key is not used: the tests run without drop path.  ``grid``
    is the DCT block grid; an RGB trainer's policy is
    :func:`jax_rgb_policy`'s at its input size."""
    import jax
    import jax.numpy as jnp
    import torch

    from rgbnomore_tpu.augment.randaugment import RandAugmentDCT
    from rgbnomore_tpu.augment.rgb import RandAugmentRGB
    from rgbnomore_tpu_torch.train.loop import StepDraws

    k_aug, k_mix, _ = jax.random.split(jax.random.fold_in(base_rng, step), 3)
    k_flip, k_pol = jax.random.split(k_aug)
    flip = jax.random.bernoulli(k_flip, 0.5, (batch,))
    cfg = trainer.cfg
    if cfg.model.domain == "RGB":
        size = cfg.model.input_size
        aug = RandAugmentRGB(ops_list=list(cfg.train.auglist), num_ops=cfg.train.num_ops,
                             magnitude=cfg.train.augstr, image_hw=(size, size), fill=128.0)
        policy = jax_rgb_policy(aug, k_pol, batch)
    else:
        aug = RandAugmentDCT(ops_list=list(cfg.train.auglist), num_ops=cfg.train.num_ops,
                             magnitude=cfg.train.augstr, grid=grid)
        policy = aug.draw_policy(k_pol, batch, grid, grid)
    u = jax.random.beta(k_mix, cfg.train.mixup_alpha, cfg.train.mixup_alpha)
    return StepDraws(torch.from_numpy(np.array(flip)),
                     tuple(torch.from_numpy(np.array(p)) for p in policy),
                     float(jnp.maximum(u, 1.0 - u)))


def tiny_swin_cfg(gen, batch=4, classes=10, drop_path=0.0, amp_dtype=None, window16=False):
    """A SwinV2 config that reaches every branch at a tiny size, from
    ``gen`` (the JAX package's or the port's ``generate_config``): depths
    (2, 2, 2), heads (2, 4, 8), embed 32, window 4, an 8x8 block grid (16x16
    tokens: 16 windows, then 4, each stage's odd block shifted, stage 3
    clamped to one window), in float32, or with ``amp_dtype`` ("bf16",
    "fp16") under AMP in it.  ``window16``: SwinV2-B/w16's window instead,
    depths (2, 2, 2, 2), heads (2, 2, 4, 4), embed 16, a 16x16 block grid
    (32x32 tokens: 4 windows of 256 tokens, the odd block shifted by 8, then
    one of 256, 64 and 16 tokens)."""
    cfg = gen("swinv2", "dct", batchsize=batch, epochs=1, warmup_steps=2, seed=5)
    cfg.model.depth, cfg.model.heads = (2, 2, 2), (2, 4, 8)
    cfg.model.embed_size, cfg.model.window_size = 32, 4
    cfg.model.pretrained_window_sizes = (0, 0, 0)
    cfg.model.drop_path, cfg.model.classes = drop_path, classes
    cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    if window16:
        cfg.model.depth, cfg.model.heads = (2, 2, 2, 2), (2, 2, 4, 4)
        cfg.model.embed_size, cfg.model.window_size = 16, 16
        cfg.model.pretrained_window_sizes = (0, 0, 0, 0)
        cfg.model.dct_blocks, cfg.model.input_size = 16, 128
    cfg.train.amp = amp_dtype is not None
    if amp_dtype is not None:
        cfg.model.amp_dtype = amp_dtype
    return cfg


def perturb_norms(params, rng):
    """A copy of a flax parameter tree with every LayerNorm scale drawn from
    U(0.5, 1.5) and its bias from N(0, 0.1^2).  SwinV2's init starts norm1
    and norm2 at scale 0, where every block is the identity and no attention
    reaches the logits."""
    out = {}
    for name, value in params.items():
        if isinstance(value, dict):
            out[name] = perturb_norms(value, rng)
        else:
            out[name] = np.asarray(value)
    if "scale" in out:
        out["scale"] = rng.uniform(0.5, 1.5, out["scale"].shape).astype(np.float32)
        out["bias"] = (rng.standard_normal(out["bias"].shape) * 0.1).astype(np.float32)
    return out


def jax_swin_trainer(amp_dtype=None, window16=False):
    """The JAX Trainer (``transfer="cropped"``) at :func:`tiny_swin_cfg`
    (with ``amp_dtype``, ``window16``), its LayerNorms perturbed.  Its ``model.init`` runs under ``jax.jit`` (10 s
    here, 30 s eagerly; the same parameters)."""
    import jax
    import jax.numpy as jnp
    import pytest

    from rgbnomore_tpu.train import loop
    from rgbnomore_tpu.train.config import generate_config
    from rgbnomore_tpu.train.steps import TrainState

    def create_train_state(model, cfg, tx, rng, example_batch):
        params = jax.jit(model.init)(rng, *example_batch)["params"]
        return TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    trainer = loop.Trainer(tiny_swin_cfg(generate_config, amp_dtype=amp_dtype,
                                         window16=window16),
                           devices=jax.devices()[:1], transfer="cropped", fused_aug=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "create_train_state", create_train_state)
        trainer.create_state(steps_per_epoch=10)
    params = perturb_norms(jax.tree.map(np.asarray, trainer.state.params),
                           np.random.default_rng(3))
    trainer.state = trainer.state.replace(params=jax.tree.map(jnp.asarray, params))
    return trainer


def port_swin_trainer(jax_trainer, cfg):
    """The port's CPU Trainer for ``cfg`` with the JAX trainer's parameters."""
    import jax

    from rgbnomore_tpu_torch.convert import flax_to_state_dict
    from rgbnomore_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, jax_trainer.state.params)))
    return trainer


def write_corpus(root, n: int = 16, size: int = 64):
    """``n`` synthetic ``size`` x ``size`` JPEGs across 4 classes, written
    by the port's codec (``tests/test_distributed.py``'s corpus), and their
    ``index.csv``; returns the index's path."""
    from pathlib import Path

    from rgbnomore_tpu_torch import codec

    root = Path(root)
    rng = np.random.default_rng(7)
    rows = ["Filepath,Label"]
    ys, xs = np.mgrid[0:size, 0:size]
    for i in range(n):
        cls = i % 4
        img = np.stack([
            (128 + 80 * np.sin(ys / (2 + cls)) * np.cos(xs / (3 + cls))).astype(np.uint8),
            (128 + 50 * np.cos(xs / (2 + cls)) + rng.integers(-9, 9)).astype(np.uint8),
            (128 + 50 * np.sin(ys / (4 + cls))).astype(np.uint8),
        ])
        p = root / f"img_{i}.jpg"
        codec.write_tensor(p, img, quality=92)
        rows.append(f"{p},{cls}")
    index = root / "index.csv"
    index.write_text("\n".join(rows) + "\n")
    return index


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's CPU ops on ``n`` threads inside the block: the trainer
    tests' models are small, and the test run shares the cores between
    several workers."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def launches(kernel: str) -> int:
    """The launches of ``kernel`` (a wrapper's name) that the port has
    counted, ``rgbnm.launch.<kernel>`` in ``utils/profiling.totals()``."""
    from rgbnomore_tpu_torch.utils import profiling

    return profiling.totals()["counters"].get(f"rgbnm.launch.{kernel}", 0)


# ------------------------------------------------------- the wire rows
def synthetic_planes(rng: np.random.Generator, n: int, grid: int):
    """Seeded dequantized coefficient planes: y (n, 1, grid, grid, 8, 8) and
    c (n, 2, grid/2, grid/2, 8, 8) float32, in [-1024, 1016], with a JPEG-like
    fall-off of magnitude with frequency and about one AC in five zero."""
    freq = np.add.outer(np.arange(8), np.arange(8)).astype(np.float32)
    amp = 300.0 / (1.0 + 2.0 * freq)

    def plane(shape):
        x = rng.standard_normal(shape + (8, 8)).astype(np.float32) * amp
        x *= rng.random(shape + (8, 8)) < 0.8
        x[..., 0, 0] = rng.uniform(-1000.0, 1000.0, shape)
        return np.clip(x, -1024.0, 1016.0).astype(np.float32)

    return plane((n, 1, grid, grid)), plane((n, 2, grid // 2, grid // 2))


def pack_mask16(blocks: np.ndarray, k: int):
    """The mask16 wire of ``native/dctcodec.cpp`` (pack_block_topk_mask16_f32)
    for blocks (n, 64) float32: exact int16 DC; the K largest ACs by int8
    magnitude (ties to the lower position) as int8 values in ascending
    position order over a uint8 scale ceil(max|AC|/127); an 8-byte
    little-endian occupancy mask.  Returns (values, mask, scale, dc)."""
    n = blocks.shape[0]
    dc = np.clip(np.rint(blocks[:, 0]), -32768, 32767).astype(np.int16)
    ac = blocks[:, 1:]
    mag = np.abs(ac)
    scale = np.clip(np.ceil(mag.max(axis=1) / np.float32(127)), 1, 255).astype(np.float32)
    inv = (np.float32(1) / scale).astype(np.float32)
    q = np.minimum((mag * inv[:, None] + np.float32(0.5)).astype(np.int32), 127)
    keep = np.zeros(q.shape, bool)
    top = np.argsort(-q, axis=1, kind="stable")[:, :k]
    np.put_along_axis(keep, top, True, axis=1)
    keep &= q > 0
    slot = np.cumsum(keep, axis=1) - 1
    rows, cols = np.nonzero(keep)
    values = np.zeros((n, k), np.int8)
    values[rows, slot[rows, cols]] = np.where(ac[rows, cols] < 0, -q[rows, cols],
                                              q[rows, cols])
    bits = np.zeros((n, 64), bool)
    bits[:, 1:] = keep
    mask = np.packbits(bits.reshape(n, 8, 8), axis=-1, bitorder="little").reshape(n, 8)
    return values, mask, scale.astype(np.uint8), dc


def row_fields(rows: np.ndarray, layout: dict) -> dict[str, np.ndarray]:
    """Writable views of every field of (n, row) uint8 rows in ``layout``
    (``packed_layout``), each (n,) + its per-sample shape, of its dtype."""
    out = {}
    for name, spec in layout.items():
        if name == "row":
            continue
        off, shape, dtype = spec
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[name] = rows[:, off:off + nbytes].view(dtype).reshape((rows.shape[0],) + shape)
    return out


def write_rows(y: np.ndarray, c: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Consolidated (n, row) uint8 rows in ``packed_layout(grid, k,
    "mask16")``, as ``DctCroppedLoader`` writes them, for planes y, c."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    n, grid = y.shape[0], y.shape[2]
    layout = packed_layout(grid, k, "mask16")
    rows = np.zeros((n, layout["row"]), np.uint8)
    f = row_fields(rows, layout)
    for tag, planes in (("y", y), ("c", c)):
        vals, mask, scale, dc = pack_mask16(planes.reshape(-1, 64), k)
        lead = planes.shape[:4]
        f[f"v{tag}"][...] = vals.reshape(lead + (k,))
        f[f"i{tag}"][...] = mask.reshape(lead + (8,))
        f[f"s{tag}"][...] = scale.reshape(lead)
        f[f"d{tag}"][...] = dc.reshape(lead)
    f["quant"][...] = 1
    f["labels"][...] = labels
    f["weights"][...] = 1.0
    return rows


def random_wire_rows(rng: np.random.Generator, n: int, grid: int, k: int,
                     fmt: str = "mask16") -> np.ndarray:
    """(n, row) uint8 rows in ``packed_layout(grid, k, fmt)`` with every
    field drawn at random, beyond what the host packer writes: each block's
    mask sets each of the 64 positions (0 included) with its own
    probability in [0, 0.5), so many blocks hold more set bits than K; the
    values span their type (int8, int16 for mask16w), scales [0, 255], DCs
    [-1500, 1500), mask16q's quant tables [0, 255]."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    layout = packed_layout(grid, k, fmt)
    rows = np.zeros((n, layout["row"]), np.uint8)
    f = row_fields(rows, layout)
    for tag in ("y", "c"):
        vals = f[f"v{tag}"]
        info = np.iinfo(vals.dtype)
        vals[...] = rng.integers(info.min, info.max + 1, vals.shape)
        mask = f[f"i{tag}"]
        density = rng.uniform(0.0, 0.5, mask.shape[:-1] + (1,))
        bits = rng.random(mask.shape[:-1] + (64,)) < density
        mask[...] = np.packbits(bits.reshape(bits.shape[:-1] + (8, 8)), axis=-1,
                                bitorder="little")[..., 0]
        f[f"s{tag}"][...] = rng.integers(0, 256, f[f"s{tag}"].shape)
        f[f"d{tag}"][...] = rng.integers(-1500, 1500, f[f"d{tag}"].shape)
    f["quant"][...] = rng.integers(0, 256, f["quant"].shape) if fmt == "mask16q" else 1
    f["labels"][...] = rng.integers(0, 1000, n)
    f["weights"][...] = 1.0
    return rows


# ------------------------------------------- the reference-named weights
# port name -> reference name (models/plainvit.py), first match; the
# embeddings whose names depend on embed_type and sub-blocks apart
VIT_REFERENCE_NAMES = [
    (r"encoder_(\d+)\.ln1\.", r"encoder.\1.0.fn.eb_lrnorm1."),
    (r"encoder_(\d+)\.mha\.", r"encoder.\1.0.fn.eb_mha."),
    (r"encoder_(\d+)\.ln2\.", r"encoder.\1.1.fn.eb_lrnorm2."),
    (r"encoder_(\d+)\.mlp1\.", r"encoder.\1.1.fn.eb_ffb.0."),
    (r"encoder_(\d+)\.mlp2\.", r"encoder.\1.1.fn.eb_ffb.3."),
    (r"head\.ln\.", "classhead.ch_lrnorm."),
    (r"head\.linear(\d)\.", r"classhead.ch_linear\1."),
    (r"patchembed\.projection\.", "patchembed.projection.0."),
    (r"patchembed\.linear_y(\d+)\.", r"patchembed.LinearY.\1."),
    (r"patchembed\.linear_c(\d+)\.", r"patchembed.LinearC.\1."),
]
VIT_EMBED_REFERENCE_NAMES = {  # (embed_type, sub-blocks) -> rules
    (2, True): [(r"patchembed\.projection_y\.", "patchembed.projection_Y.1."),
                (r"patchembed\.projection_c\.", "patchembed.projection_C.1."),
                (r"patchembed\.linear_mix\.", "patchembed.linearMix.")],
    (2, False): [(r"patchembed\.linear_mix\.", "patchembed.LinearMix.")],
    (3, True): [(r"patchembed\.projection_y\.", "patchembed.projectionY.1."),
                (r"patchembed\.projection_c\.", "patchembed.projectionC.1.")],
}
# port name -> reference name (models/swinv2.py)
SWIN_REFERENCE_NAMES = [
    (r"layer(\d+)_block(\d+)\.attn\.cpb_mlp1\.", r"layers.\1.blocks.\2.attn.cpb_mlp.0."),
    (r"layer(\d+)_block(\d+)\.attn\.cpb_mlp2\.", r"layers.\1.blocks.\2.attn.cpb_mlp.2."),
    (r"layer(\d+)_block(\d+)\.mlp(\d)\.", r"layers.\1.blocks.\2.mlp.fc\3."),
    (r"layer(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
    (r"layer(\d+)_downsample\.", r"layers.\1.downsample."),
    (r"patch_embed\.projection\.", "patch_embed.projection.0."),
    (r"patch_embed\.(weight|bias)$", r"patch_embed.proj.\1"),
    (r"patch_norm\.", "patch_embed.norm."),
]


def reference_state_dict(model, rules, rng, std: float) -> dict:
    """A state dict under the reference's module names (``rules``, the first
    match renames) with ``model``'s shapes, drawn from ``rng``: weights and
    biases N(0, std^2), LayerNorm scales 1 + N(0, 0.1^2), SwinV2's logit
    scales log 10 + N(0, 0.1^2); the ViT's fused qkv rows are so random,
    not symmetric under the reference's (h, d, qkv) interleave."""
    import torch

    out = {}
    for key, value in model.state_dict().items():
        arr = rng.standard_normal(tuple(value.shape)).astype(np.float32)
        if key.endswith("logit_scale"):
            arr = np.float32(math.log(10)) + np.float32(0.1) * arr
        elif re.search(r"(ln\d?|norm\d?)\.weight$", key):
            arr = 1 + np.float32(0.1) * arr
        else:
            arr *= np.float32(std)
        for pattern, repl in rules:
            key, n = re.subn(pattern, repl, key)
            if n:
                break
        out[key] = torch.from_numpy(arr)
    return out


# -------------------------------------------------- ILSVRC-shaped tars
def val_names(n: int) -> list[str]:
    """The file names of the first ``n`` images of ImageNet's val set."""
    return [f"ILSVRC2012_val_{i:08d}.JPEG" for i in range(1, n + 1)]


def write_imagenet_tars(root, rng, classes=("n01440764", "n01443537"), per_class=2, n_val=2,
                        size=(32, 32)):
    """ILSVRC-shaped tars of random ``size`` (width, height) JPEGs in
    ``root/src``: the train tar an outer tar of ``per_class`` images in a
    tar for each of ``classes``, the val tar ``n_val`` flat images named as
    the real val set's (:func:`val_names`); returns ``root/src``."""
    import tarfile
    from pathlib import Path

    from PIL import Image

    src, scratch = Path(root) / "src", Path(root) / "scratch"
    src.mkdir()
    scratch.mkdir()

    def jpg(path):
        arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(arr, "RGB").save(path, "JPEG")

    class_tars = []
    for cls in classes:
        cdir = scratch / cls
        cdir.mkdir()
        for i in range(per_class):
            jpg(cdir / f"{cls}_{i}.JPEG")
        ct = scratch / f"{cls}.tar"
        with tarfile.open(ct, "w") as t:
            for p in sorted(cdir.iterdir()):
                t.add(p, arcname=p.name)
        class_tars.append(ct)
    with tarfile.open(src / "ILSVRC2012_img_train.tar", "w") as t:
        for ct in class_tars:
            t.add(ct, arcname=ct.name)
    for name in val_names(n_val):
        jpg(scratch / name)
    with tarfile.open(src / "ILSVRC2012_img_val.tar", "w") as t:
        for name in val_names(n_val):
            t.add(scratch / name, arcname=name)
    return src


# -------------------------------------------------- traces and ptxas
def port_spans(events: list) -> list[dict]:
    """The port's spans (``rgbnm.*`` host events; the profiler repeats each
    span that launched device work on the device's timeline as a
    ``gpu_user_annotation``, left out here) among a Chrome trace's events:
    name, host thread, start and end (µs) and index (the span's one input,
    None without one)."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation" \
                or not str(e.get("name", "")).startswith("rgbnm."):
            continue
        inputs = e.get("args", {}).get("Concrete Inputs") or [""]
        out.append({"name": e["name"], "tid": e.get("tid"), "ts": float(e["ts"]),
                    "end": float(e["ts"]) + float(e["dur"]),
                    "index": int(inputs[0]) if inputs[0] != "" else None})
    return out


def spans_per_step(spans: list) -> tuple[list[dict], list[str]]:
    """For each ``rgbnm.step`` span, in order: its index and how many of
    each other port span lie inside it in time (on any thread); and the
    names of the spans that lie in no step."""
    steps = sorted((s for s in spans if s["name"] == "rgbnm.step"), key=lambda s: s["ts"])
    rows = [{"index": st["index"], "spans": collections.Counter()} for st in steps]
    outside = []
    for s in spans:
        if s["name"] == "rgbnm.step":
            continue
        home = [r for r, st in zip(rows, steps) if st["ts"] <= s["ts"] and s["end"] <= st["end"]]
        if home:
            home[0]["spans"][s["name"]] += 1
        else:
            outside.append(s["name"])
    return [{"index": r["index"], "spans": dict(r["spans"])} for r in rows], outside


def mangled_kernel(line: str) -> str | None:
    """The name of the ``*_kernel`` function in a ptxas line's mangled
    symbol, read by the symbol's length prefixes (``_ZN<len><name>...``)."""
    for m in re.finditer(r"_ZN?(?=\d)", line):
        pos = m.end()
        while True:
            digits = re.match(r"\d+", line[pos:])
            if digits is None:
                break
            start = pos + len(digits.group())
            name = line[start:start + int(digits.group())]
            if name.endswith("_kernel"):
                return name
            pos = start + len(name)
    return None


def kernel_instance(symbol: str) -> str:
    """``kernel<dtype,ints>`` of a mangled kernel symbol: the element type of a
    half-precision kernel, then its integer template arguments."""
    dtype = re.findall(r"I(?:6__half|13__nv_bfloat16)", symbol)
    targs = [t.split("_")[-1] for t in dtype] + re.findall(r"Li(\d+)E", symbol)
    return (mangled_kernel(symbol) or symbol) + "<" + ",".join(targs) + ">"
