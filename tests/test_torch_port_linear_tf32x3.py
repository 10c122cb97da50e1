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
  kernel takes (``check_shape``), and so is every float32 qkv product of
  the SwinV2 presets at the benchmark cells' batches;
- a bf16 or fp16 weight (exact in TF32) gives what its float32 promotion
  gives, its gradient rounded to its dtype;
- SwinV2's window attention: a float32 qkv product goes through
  ``linear_tf32x3`` with the q/v bias in its epilogue, its product and
  gradients against float64 and its parameters' gradients through the
  same casts; a half-precision one keeps ``F.linear``.
On the card (marker ``cuda``): the kernels against the plain version at
ragged shapes and SwinV2's qkv widths, the weight gradient repeated bit for
bit, and a half weight (its lo half left out) bit for bit against its
float32 promotion (the three-product path).
"""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_support import mm_1xtf32, settle_inspect_module_walk
from rgbnomore_tpu_torch.models import SwinTransformerV2, ViT, swinv2
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


# (rows, K, N) of SwinV2's float32 qkv products -> blocks, at the benchmark
# cells' batches (SwinV2-T 512, SwinV2-B/w16 256): every block but the first,
# whose input is still in the compute dtype
SWIN_QKV = {
    "swinv2": (512, {(2097152, 96, 288): 1, (524288, 192, 576): 2, (131072, 384, 1152): 6,
                     (32768, 768, 2304): 2}),
    "swinv2b": (256, {(1048576, 128, 384): 1, (262144, 256, 768): 2, (65536, 512, 1536): 18,
                      (16384, 1024, 3072): 2}),
}


@pytest.mark.parametrize("preset", list(SWIN_QKV))
def test_swin_float32_qkv_shapes_are_taken(preset):
    """Every float32 qkv product of the SwinV2 presets (bf16 AMP: 11 a
    SwinV2-T forward, 23 a SwinV2-B/w16 one) is one the kernel takes at the
    benchmark cell's batch (``check_shape``)."""
    batch, want = SWIN_QKV[preset]
    m = generate_config(preset, "dct").model
    with torch.device("meta"):
        model = SwinTransformerV2(
            img_size=m.input_size, num_classes=m.classes, embed_dim=m.embed_size,
            depths=tuple(m.depth), num_heads=tuple(m.heads), window_size=m.window_size,
            mlp_ratio=float(m.mlp_ratio), qkv_bias=m.qkv_bias, ape=m.ape,
            patch_norm=m.patch_norm, pretrained_window_sizes=tuple(m.pretrained_window_sizes),
            pixel_space=m.domain, dtype=torch.bfloat16, patch_size=m.patch_size)
    blocks = [mod for mod in model.modules() if isinstance(mod, swinv2.SwinBlock)][1:]
    got = collections.Counter()
    for blk in blocks:
        h, w = blk.input_resolution
        dim = blk.attn.dim
        L.check_shape(batch * h * w, 3 * dim, dim)
        got[(batch * h * w, dim, 3 * dim)] += 1
    assert got == want


def test_half_weight_is_promoted_on_cpu():
    """A bf16 or fp16 weight is exact in TF32: the output and the gradients
    of x and the bias equal its float32 promotion's bit for bit, and its own
    gradient is the promotion's rounded to its dtype (as the promotion's
    backward rounds it); a float64 weight is refused."""
    x, w, b = _data(24, 40, 56, seed=4)
    for dt in (torch.bfloat16, torch.float16):
        outs = []
        for weight in (w.to(dt), w.to(dt).float()):
            leaves = [t.clone().requires_grad_(True) for t in (x, weight, b)]
            out = L.linear_tf32x3(*leaves)
            outs.append([out, *torch.autograd.grad(out, leaves, torch.ones_like(out))])
        (out, gx, gw, gb), (out32, gx32, gw32, gb32) = outs
        assert gw.dtype == dt and torch.equal(gw, gw32.to(dt))
        assert torch.equal(out, out32) and torch.equal(gx, gx32) and torch.equal(gb, gb32)
    with pytest.raises(TypeError, match="float32"):
        L.linear_tf32x3(x, w.double(), b)


class _Ops(TorchDispatchMode):
    """Counts the operators a block of code dispatches, by name."""

    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _spy_qkv(monkeypatch) -> list[dict]:
    """Each call of ``linear_tf32x3`` from ``models/swinv2.py``: its
    inputs and its output."""
    calls = []

    def spy(x, weight, bias=None):
        out = L.linear_tf32x3(x, weight, bias)
        calls.append({"x": x, "weight": weight, "bias": bias, "out": out})
        return out

    monkeypatch.setattr(swinv2, "linear_tf32x3", spy)
    return calls


def _window_attention(dtype) -> swinv2.WindowAttention:
    torch.manual_seed(5)
    mod = swinv2.WindowAttention(32, 4, 2, dtype=dtype)
    with torch.no_grad():  # the q and v biases start at zero
        mod.q_bias.normal_(0.0, 0.5)
        mod.v_bias.normal_(0.0, 0.5)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_swin_float32_qkv_takes_the_kernel(dtype, monkeypatch):
    """A window attention whose qkv product is float32 (a later block's
    float32 input under AMP; every block of a float32 model) computes it by
    ``linear_tf32x3`` (on the CPU the ``rgbnm::mm_tf32x3`` operator): the
    weight in the compute dtype (which ``linear_tf32x3`` promotes), the q/v
    bias rounded to it in the epilogue.  The product, and the gradients of
    x, of the promoted weight and of the float32 bias, within 4e-6 of
    float64 on the same casts; the gradient of the weight it took is the
    promoted one's rounded to the compute dtype, and the parameters'
    gradients are those, rounded back through the casts (``.to(dtype)``)."""
    mod = _window_attention(dtype)
    x = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(6), requires_grad=True)
    calls = _spy_qkv(monkeypatch)
    profiling.reset()
    with _Ops() as ops:
        mod(x, None)
    assert len(calls) == 1 and ops.names["rgbnm.mm_tf32x3"] >= 1
    # the proj Linear computes in dtype: F.linear, counted, for a half dtype
    assert profiling.totals()["counters"].get("rgbnm.linear.library", 0) == (
        0 if dtype == torch.float32 else 1)
    call = calls[0]
    w, b, qkv = call["weight"], call["bias"], call["out"]
    assert call["x"] is x and w.dtype == dtype
    assert torch.equal(w, mod.qkv.weight.to(dtype))
    zeros = torch.zeros_like(mod.q_bias)
    assert torch.equal(b, torch.cat([mod.q_bias, zeros, mod.v_bias]).to(dtype).float())
    assert _err(qkv.detach(), F.linear(x.double(), w.double(), b.double())) < 4e-6

    dqkv = torch.randn(qkv.shape, generator=torch.Generator().manual_seed(7))
    params = [mod.qkv.weight, mod.q_bias, mod.v_bias]
    gx, gw, gb, g_weight, g_q, g_v = torch.autograd.grad(qkv, [x, w, b, *params], dqkv)
    d2, x2 = dqkv.double().reshape(-1, 96), x.detach().double().reshape(-1, 32)
    assert _err(gx, dqkv.double() @ w.double()) < 4e-6
    gw32 = L.mm_tf32x3(d2.float().T.contiguous(), x2.float().T.contiguous())
    assert _err(gw32, d2.T @ x2) < 4e-6 and torch.equal(gw, gw32.to(dtype))
    assert _err(gb, d2.sum(0)) < 4e-6
    assert torch.equal(g_weight, gw.float())
    assert torch.equal(g_q, gb[:32].to(dtype).float())
    assert torch.equal(g_v, gb[64:].to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_swin_half_qkv_stays_on_the_library(dtype, monkeypatch):
    """The first block's half-precision input keeps ``F.linear`` for its
    qkv product (rounded after the product and again after the bias, as
    flax), counted once in ``rgbnm.linear.library`` beside the proj's; no
    ``linear_tf32x3`` call."""
    mod = _window_attention(dtype)
    x = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(6)).to(dtype)
    calls = _spy_qkv(monkeypatch)
    profiling.reset()
    with torch.no_grad():
        out = mod(x, None)
    counters = profiling.totals()["counters"]
    assert out.dtype == dtype and not calls
    assert counters["rgbnm.linear.library"] == 2  # the qkv product and the proj
    assert not any(name.startswith("rgbnm.launch.linear") for name in counters)


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


# (rows, K, N) on the card: ragged shapes, ViT's, and SwinV2's qkv in stages 1
# and 3 (SwinV2-T K 96 and 384, SwinV2-B/w16 K 128 and 512)
CARD_SHAPES = [(1000, 384, 1152), (300, 64, 170), (513, 1536, 384), (40, 7, 3),
               (4096, 96, 288), (3000, 128, 384), (2048, 384, 1152), (2500, 512, 1536)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(shape):
    """Forward, input and weight gradients (with the bias gradient) against
    the plain version on the card (both within 2e-5 of the largest float64
    entry), the weight gradient repeated bit for bit."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[4:])
def test_half_weight_is_bit_identical_on_card(shape):
    """A bf16 or fp16 weight (SwinV2's qkv under AMP): the forward and the
    input gradient that leave the products with its zero lo half out equal
    its float32 promotion's three-product path bit for bit."""
    _card()
    m, k, n = shape
    x, w, b = (t.cuda() for t in _data(m, k, n, seed=8))
    dy = torch.randn(m, n, device="cuda", generator=torch.Generator("cuda").manual_seed(9))
    for half in (w.bfloat16(), w.half()):
        assert torch.equal(L.linear_fwd(x, half, b), L.linear_fwd(x, half.float(), b))
        assert torch.equal(L.linear_dgrad(dy, half), L.linear_dgrad(dy, half.float()))
