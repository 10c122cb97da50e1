"""The float32 Linear in 3xTF32 (``rgbnomore_tpu_torch/ops/linear.py``,
kernel ``csrc/linear_tf32x3.cu``).

On the CPU:
- the plain version (``mm_tf32x3``, the kernel's arithmetic) against
  float64 at the ViT-Ti and ViT-S widths: at least 10x closer than one TF32
  pass;
- the autograd Function's dx, dW and db against float64;
- the dispatch rule of ``models/layers.py:Linear``: float32 on the CPU to
  the plain version, bf16 and fp16 to ``F.linear`` (counted in
  ``rgbnm.linear.library``), no kernel launch counted on the CPU;
- ``model_flops`` counts a Linear as one product of 2 M N K, as before;
- every float32 Linear of every preset, embed type and domain is one the
  kernel takes (``check_shape``).
On the card (marker ``cuda``): the kernels against the plain version at
ragged shapes, the weight gradient repeated bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F

from torch_port_support import mm_1xtf32, settle_inspect_module_walk
from rgbnomore_tpu_torch.models import SwinTransformerV2, ViT
from rgbnomore_tpu_torch.models.layers import Linear
from rgbnomore_tpu_torch.ops import linear as L
from rgbnomore_tpu_torch.train.config import amp_compute_dtype, generate_config
from rgbnomore_tpu_torch.utils import profiling

# (in, out) of the ViT block's four Linears at the ViT-Ti and ViT-S widths
WIDTHS = {"vitti": 192, "vits": 384}
PRODUCTS = {"qkv": (1, 3), "proj": (1, 1), "mlp1": (1, 4), "mlp2": (4, 1)}


def _data(m, k, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(n, k, generator=gen) / k ** 0.5
    b = torch.randn(n, generator=gen)
    return x, w, b


def _err(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("product", list(PRODUCTS))
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_plain_is_float32_close(arch, product):
    """``linear_plain`` against ``F.linear`` in float64: the 3xTF32 error is
    at least 10x below one TF32 pass's, and within 4e-6 of the largest
    output."""
    e = WIDTHS[arch]
    k, n = e * PRODUCTS[product][0], e * PRODUCTS[product][1]
    x, w, b = _data(64, k, n)
    want = F.linear(x.double(), w.double(), b.double())
    err3 = _err(L.linear_plain(x, w, b), want)
    err1 = _err(mm_1xtf32(x, w.T) + b, want)
    assert err3 * 10 <= err1, (err3, err1)
    assert err3 < 4e-6


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 49, 192, 576), (3, 5, 24, 96), (2, 7, 64, 170)])
def test_function_gradients_against_float64(shape, bias):
    """dx, dW and db of ``linear_tf32x3`` on (B, N, K) inputs against
    autograd of ``F.linear`` in float64."""
    bsz, tokens, k, n = shape
    x, w, b = _data(bsz * tokens, k, n, seed=1)
    x = x.reshape(bsz, tokens, k)
    b = b if bias else None
    dy = torch.randn(bsz, tokens, n, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]
    out = L.linear_tf32x3(*leaves, *(() if bias else (None,)))
    got = torch.autograd.grad(out, leaves, dy)
    ref_leaves = [t.double().requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]
    ref = F.linear(*ref_leaves, *(() if bias else (None,)))
    want = torch.autograd.grad(ref, ref_leaves, dy.double())
    assert _err(out.detach(), ref.detach()) < 4e-6
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert _err(g, r) < 4e-6


def test_function_skips_gradients_not_needed():
    """A frozen input (the embedding's data) gets no input gradient; the
    weight's still comes."""
    x, w, b = _data(10, 24, 8)
    w.requires_grad_(True)
    L.linear_tf32x3(x, w, b).sum().backward()
    assert w.grad is not None and x.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_linear_dispatch(dtype):
    """float32 takes the plain version on the CPU; bf16 and fp16 take
    ``F.linear``, counted once a call in ``rgbnm.linear.library``; no
    kernel launch is counted on the CPU."""
    torch.manual_seed(0)
    layer = Linear(40, 24, dtype=dtype)
    x = torch.randn(3, 7, 40)
    profiling.reset()
    got = layer(x)
    counters = profiling.totals()["counters"]
    if dtype == torch.float32:
        assert torch.equal(got, L.linear_plain(x, layer.weight, layer.bias))
        assert "rgbnm.linear.library" not in counters
    else:
        want = F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
        assert got.dtype == dtype and torch.equal(got, want)
        assert counters["rgbnm.linear.library"] == 1
    assert not any(name.startswith("rgbnm.launch.linear") for name in counters)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, b = _data(4, 8, 8)
    for call in (lambda: L.linear_fwd(x, w, b), lambda: L.linear_dgrad(x, w),
                 lambda: L.linear_wgrad(x, x)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def test_model_flops_counts_a_linear_once():
    """``mm_tf32x3`` is one operator whose FLOP count is 2 M N K: a Linear
    counts as ``F.linear`` does, though the plain version runs three
    products."""
    from torch.utils.flop_counter import FlopCounterMode

    settle_inspect_module_walk()  # the counter's first use imports torch._dynamo
    x, w, b = _data(37, 24, 40)
    for fn in (lambda: L.linear_plain(x, w, b), lambda: F.linear(x, w, b)):
        with FlopCounterMode(display=False) as counter:
            fn()
        assert counter.get_total_flops() == 2 * 37 * 24 * 40


def _preset_models():
    """(tag, model on the meta device, tokens an image) for every float32
    model the presets make: each arch at float32, every DCT embed type (1, 2
    and 3, with and without sub-blocks where it has them) and RGB."""
    for arch in ("vitti", "vits", "vitb", "vitl", "swinv2"):
        variants = [("rgb", None, None)] + (
            [("dct", None, None)] if arch == "swinv2" else
            [("dct", ver, sub) for ver in (1, 2, 3) for sub in (True, False)])
        for domain, ver, sub in variants:
            cfg = generate_config(arch, domain, modelver=ver, subblock=sub, amp=False)
            assert amp_compute_dtype(cfg) == torch.float32
            m = cfg.model
            if arch == "vitl" and ver == 2 and sub:
                continue  # refused at construction: 1,024 is not a multiple of 6
            with torch.device("meta"):
                if arch == "swinv2":
                    model = SwinTransformerV2(
                        img_size=m.input_size, num_classes=m.classes, embed_dim=m.embed_size,
                        depths=tuple(m.depth), num_heads=tuple(m.heads),
                        window_size=m.window_size, mlp_ratio=float(m.mlp_ratio),
                        qkv_bias=m.qkv_bias, ape=m.ape, patch_norm=m.patch_norm,
                        pretrained_window_sizes=tuple(m.pretrained_window_sizes),
                        pixel_space=m.domain, dtype=torch.float32, patch_size=m.patch_size)
                else:
                    model = ViT(patch_size=m.patch_size, emb_size=m.embed_size,
                                depth=int(m.depth), num_heads=int(m.heads),
                                head_size=m.head_size, n_classes=m.classes,
                                pixel_space=m.domain, ver=m.version, use_subblock=m.subblock,
                                dtype=torch.float32)
            tokens = (m.input_size // m.patch_size) ** 2
            yield f"{arch}-{domain}-{ver}-{sub}", model, tokens


def test_every_float32_preset_linear_is_taken():
    """Every ``Linear`` of every float32 preset model computes in float32
    (so through the kernel on the card), at shapes ``check_shape`` takes at
    the presets' batch of 1,024 (ViT-L's separate embedding included: 170
    output columns, a row stride TMA cannot describe, loaded by the
    producer warp)."""
    shapes = set()
    for tag, model, tokens in _preset_models():
        layers = [mod for mod in model.modules() if isinstance(mod, Linear)]
        assert layers, tag
        for mod in layers:
            assert mod.compute_dtype == torch.float32, tag
            L.check_shape(1024 * tokens, mod.out_features, mod.in_features)
            shapes.add((mod.in_features, mod.out_features))
    assert {(384, 1152), (384, 384), (384, 1536), (1536, 384), (64, 170), (24, 96)} <= shapes
    with pytest.raises(ValueError, match="empty"):
        L.check_shape(0, 8, 8)


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 384, 1152), (300, 64, 170), (513, 1536, 384),
                                   (40, 7, 3)])
def test_kernels_match_plain_on_card(shape):
    """Forward, input and weight gradients against the plain version on the
    card (both within 4e-6 of the largest float64 entry at ViT widths), the
    weight gradient repeated bit for bit."""
    _card()
    m, k, n = shape
    x, w, b = (t.cuda() for t in _data(m, k, n))
    dy = torch.randn(m, n, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    got = [L.linear_fwd(x, w, b), L.linear_dgrad(dy, w), *L.linear_wgrad(dy, x)]
    again = L.linear_wgrad(dy, x)
    want = [F.linear(x.double(), w.double(), b.double()), dy.double() @ w.double(),
            dy.double().T @ x.double(), dy.double().sum(0)]
    plain = [L.linear_plain(x, w, b), L.mm_tf32x3(dy, w.T.contiguous()),
             L.mm_tf32x3(dy.T.contiguous(), x.T.contiguous()), dy.sum(0)]
    for g, p, r in zip(got, plain, want):
        assert _err(g, r) < 2e-5 and _err(p, r) < 2e-5
    assert torch.equal(again[0], got[2]) and torch.equal(again[1], got[3])
