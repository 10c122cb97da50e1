"""Device-side RGB augmentation: batched RandomResizedCrop and RandAugment on
pixels (PyTorch).

Port of ``rgbnomore_tpu/augment/rgb.py``, the replacement for the
reference's PIL / torchvision CPU transforms (``datasets.py:317-353``,
``utils/custom_transforms.py:15-314``):

- Crop and resize are separable: per-sample row and column resampling
  matrices with scale-aware triangle (antialiased bilinear) filters, PIL's
  downscale, applied as two batched products in full float32.
- Pixel ops work in float32 [0, 255] with clamping where torchvision's
  uint8 ops round; magnitudes follow the big_vision table
  (``custom_transforms.py:266-291``).
- YCbCr ops (ChromaDrop, AutoSaturation) use the ITU-R BT.601 full-range
  matrix, PIL's.

Unlike the JAX module, which draws inside each op from a key, the random
decisions are drawn up front: :meth:`RandAugmentRGB.draw_policy` gives, per
sample and round, the op index, the sign, the Cutout centre (any pixel)
and ChromaDrop's bit; ``RandomResizedCropRGB.draw`` gives the crop boxes.
Each round groups the samples by op and runs each op once on its group, as
``RandAugmentDCT.apply`` does.  Equalize's histograms are ``bincount``s on
offset bin indices, exact integers on the card too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rgbnomore_tpu_torch.augment.randaugment import split_by_sign
from rgbnomore_tpu_torch.ops.blocks import float32_products
from rgbnomore_tpu_torch.ops.geometry import rotate_image, shear_image

__all__ = ["RandAugmentRGB", "RandomResizedCropRGB", "RgbTrainPipeline", "apply_separable_rgb",
           "make_resize_center_crop_rgb", "make_rgb_eval_pipeline", "make_rgb_train_pipeline",
           "resample_matrix", "to_unit_range"]


# ---------------------------------------------------------------- resample --
def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device: a division by
    it is a true division on the card (a host scalar divisor becomes a
    multiply by its reciprocal there)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def resample_matrix(src_start: torch.Tensor, src_size: torch.Tensor, n_src: int,
                    n_out: int) -> torch.Tensor:
    """(B, n_out, n_src) antialiased-bilinear resampling matrices for one
    axis, one per sample of ``src_start`` and ``src_size`` (B,) float32.
    Output sample r maps to the source coordinate ``src_start + (r + 0.5) *
    src_size / n_out - 0.5`` with a triangle filter whose support scales
    with the downscale factor (PIL's bilinear)."""
    src_start = src_start.to(torch.float32)[:, None, None]
    scale = src_size.to(torch.float32)[:, None, None] / _scalar(n_out, src_size)
    support = torch.clamp(scale, min=1.0)
    r = torch.arange(n_out, dtype=torch.float32, device=scale.device)[:, None]
    centers = src_start + (r + 0.5) * scale - 0.5  # (B, n_out, 1)
    s = torch.arange(n_src, dtype=torch.float32, device=scale.device)[None, :]
    weights = torch.clamp(1.0 - torch.abs(s - centers) / support, min=0.0)
    norm = weights.sum(dim=2, keepdim=True)
    return weights / torch.clamp(norm, min=1e-8)


def apply_separable_rgb(img: torch.Tensor, m_h: torch.Tensor, m_w: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W) x m_h (B, OH, H) x m_w (B, OW, W) -> (B, C, OH, OW),
    in full float32."""
    with float32_products():
        t = m_h[:, None] @ img.to(torch.float32)
        return t @ m_w[:, None].transpose(-1, -2)


class RandomResizedCropRGB:
    """Batched torchvision-style RandomResizedCrop (``datasets.py:319``) of a
    ``canvas`` square to ``out_size``: ``tries`` candidate boxes a sample,
    the first in bounds taken, else the whole canvas (the reference's
    fallback for a square).  ``draw(generator, batch)`` gives the boxes
    ``(i, j, h, w)`` (B,) float32 from four (B, tries) draws (:meth:`boxes`,
    which a test feeds JAX's); ``crop(img, boxes)`` resamples."""

    def __init__(self, out_size: int, canvas: int, scale=(0.05, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0), tries: int = 10):
        self.out_size, self.canvas, self.tries = out_size, canvas, tries
        self.scale = scale
        self.log_ratio = (float(np.log(ratio[0])), float(np.log(ratio[1])))

    def boxes(self, area_frac, log_ar, u_i, u_j):
        """The boxes from the draws (each (B, tries)): the area's share of
        the canvas in ``scale``, the log aspect in the log ``ratio`` range and
        two uniforms in [0, 1) for the corner, in the JAX function's
        arithmetic: w = round(sqrt(area aspect)), h = round(sqrt(area /
        aspect)), the first valid try, its corner floor(u (canvas - side +
        1))."""
        cv = float(self.canvas)
        area = cv * cv * area_frac
        ar = torch.exp(log_ar)
        w = torch.round(torch.sqrt(area * ar))
        h = torch.round(torch.sqrt(area / ar))
        valid = (w <= cv) & (h <= cv) & (w > 0) & (h > 0)
        first = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)
        found = valid.any(dim=1)

        def take(x):
            return torch.gather(x, 1, first)[:, 0]

        w_sel = torch.where(found, take(w), cv)
        h_sel = torch.where(found, take(h), cv)
        i = torch.floor(take(u_i) * (cv - h_sel + 1))
        j = torch.floor(take(u_j) * (cv - w_sel + 1))
        return i, j, h_sel, w_sel

    def draw(self, generator: torch.Generator, batch: int):
        shape, dev = (batch, self.tries), generator.device
        u = [torch.rand(shape, generator=generator, device=dev) for _ in range(4)]
        (lo, hi), (lr0, lr1) = self.scale, self.log_ratio
        return self.boxes(u[0] * (hi - lo) + lo, u[1] * (lr1 - lr0) + lr0, u[2], u[3])

    def crop(self, img: torch.Tensor, boxes) -> torch.Tensor:
        i, j, h, w = (t.to(img.device) for t in boxes)
        m_h = resample_matrix(i, h, self.canvas, self.out_size)
        m_w = resample_matrix(j, w, self.canvas, self.out_size)
        return apply_separable_rgb(img, m_h, m_w)


def make_resize_center_crop_rgb(resize_to: int, crop: int, canvas: int):
    """The eval transform Resize(resize_to) + CenterCrop(crop)
    (``datasets.py:331-334``) of a ``canvas`` square, composed into one
    source box: ``fn(img (B, 3, canvas, canvas)) -> (B, 3, crop, crop)``."""
    scale = canvas / resize_to
    start, size = (resize_to - crop) / 2 * scale, crop * scale

    def run(img: torch.Tensor) -> torch.Tensor:
        b = img.shape[0]
        m = resample_matrix(_scalar(start, img).reshape(1), _scalar(size, img).reshape(1),
                            canvas, crop).expand(b, -1, -1)
        return apply_separable_rgb(img, m, m)

    return run


def to_unit_range(img: torch.Tensor) -> torch.Tensor:
    """ToTensor (x / 255) then the range [-1, 1]: ``x / 255 * 2 - 1``."""
    return img / _scalar(255.0, img) * 2.0 - 1.0


# ------------------------------------------------------------- pixel ops ---
_YCBCR = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    np.float32,
)
_YCBCR_INV = np.linalg.inv(_YCBCR).astype(np.float32)


def _color_matrix(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``mat`` (3, 3) times the channels of ``x`` (n, 3, H, W)."""
    m = torch.from_numpy(mat).to(x.device)
    with float32_products():
        return (m @ x.reshape(x.shape[0], 3, -1)).reshape(x.shape)


def _to_ycbcr(img: torch.Tensor) -> torch.Tensor:
    out = _color_matrix(_YCBCR, img)
    out[:, 1:] += 128.0
    return out


def _from_ycbcr(ycc: torch.Tensor) -> torch.Tensor:
    ycc = ycc.clone()
    ycc[:, 1:] -= 128.0
    return _color_matrix(_YCBCR_INV, ycc)


def _clamp(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img, 0.0, 255.0)


def _per_sample(t: torch.Tensor) -> torch.Tensor:
    """A (n,) per-sample value broadcast over (C, H, W)."""
    return t.reshape(-1, 1, 1, 1)


def _blend(img1: torch.Tensor, img2, f: torch.Tensor) -> torch.Tensor:
    """torchvision's blend: img1 * f + img2 * (1 - f), clamped; ``f`` (n,)."""
    f = _per_sample(f)
    return _clamp(f * img1 + (1.0 - f) * img2)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """The luma (n, 1, H, W) of ``img`` (n, 3, H, W)."""
    return (0.299 * img[:, 0] + 0.587 * img[:, 1] + 0.114 * img[:, 2])[:, None]


def _equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL's ``ImageOps.equalize`` per sample and channel, exactly: ``step =
    (total - count of the last non-empty bin) // 255``, ``lut[i] = (step // 2
    + sum(h[:i])) // step``; the channel unchanged where it has at most one
    distinct value or ``step == 0``."""
    n, ch, h, w = img.shape
    rows = n * ch
    idx = torch.clamp(torch.round(img), 0, 255).reshape(rows, h * w).to(torch.int64)
    offset = torch.arange(rows, device=img.device)[:, None] * 256
    hist = torch.bincount((idx + offset).reshape(-1), minlength=rows * 256).reshape(
        rows, 256).to(torch.float32)
    nonzero = hist > 0
    last_nz = 255 - torch.argmax(torch.flip(nonzero, dims=(1,)).to(torch.int8), dim=1,
                                 keepdim=True)
    step = torch.floor((hist.sum(dim=1, keepdim=True) - torch.gather(hist, 1, last_nz))
                       / _scalar(255.0, img))
    excl_cdf = torch.cumsum(hist, dim=1) - hist
    lut = torch.floor((torch.div(step, 2, rounding_mode="floor") + excl_cdf)
                      / torch.clamp(step, min=1.0))
    out = torch.gather(torch.clamp(lut, 0, 255), 1, idx).reshape(n, ch, h, w)
    identity = (nonzero.sum(dim=1) <= 1) | (step[:, 0] == 0)
    return torch.where(identity.reshape(n, ch, 1, 1), img, out)


def _smooth(img: torch.Tensor) -> torch.Tensor:
    """PIL's SMOOTH filter ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13) on the
    interior; the border keeps the original (torchvision's sharpness)."""
    h, w = img.shape[-2:]
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1), mode="replicate")
    edge, centre = np.float32(1.0 / 13.0), np.float32(5.0 / 13.0)
    sm = None
    for dy in range(3):
        for dx in range(3):
            tap = pad[..., dy:dy + h, dx:dx + w] * float(centre if dy == dx == 1 else edge)
            sm = tap if sm is None else sm + tap
    out = img.clone()
    out[..., 1:-1, 1:-1] = sm[..., 1:-1, 1:-1]
    return out


def _translate(img: torch.Tensor, t: int, dim: int, fill: float) -> torch.Tensor:
    """Shift by ``t`` pixels along ``dim``, the gap filled."""
    out = torch.roll(img, t, dims=dim)
    n = img.shape[dim]
    idx = torch.arange(n, device=img.device)
    keep = idx >= t if t >= 0 else idx < n + t
    shape = [1] * img.dim()
    shape[dim] = n
    return torch.where(keep.reshape(shape), out, _scalar(fill, img))


def _cutout(img: torch.Tensor, pad_size: int, ch: torch.Tensor, cw: torch.Tensor,
            fill: float) -> torch.Tensor:
    """Fill a ``2*pad_size`` square centred at each sample's (ch, cw)."""
    h, w = img.shape[-2:]
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    ch, cw = ch.to(img.device)[:, None], cw.to(img.device)[:, None]
    hole = (((rows >= ch - pad_size) & (rows < ch + pad_size))[:, :, None]
            & ((cols >= cw - pad_size) & (cols < cw + pad_size))[:, None, :])
    return torch.where(hole[:, None], _scalar(fill, img), img)


def _rgb_magnitude_table(num_bins: int, hw: tuple[int, int]):
    """The big_vision magnitude table (``custom_transforms.py:266-291``)."""
    lin = lambda a, b: np.linspace(a, b, num_bins)  # noqa: E731
    zero = np.zeros(num_bins)
    h, w = hw
    return {
        "Identity": (zero, False),
        "AutoContrast": (zero, False),
        "Equalize": (zero, False),
        "Invert": (zero, False),
        "Rotate": (lin(0.0, 30.0), True),
        "Posterize": (8 - np.round(np.arange(num_bins) / ((num_bins - 1) / 4)), False),
        "Solarize": (lin(255.0, 0.0), False),
        "SolarizeAdd": (lin(0, 110), False),
        "Color": (lin(0.0, 0.9), True),
        "Contrast": (lin(0.0, 0.9), True),
        "Brightness": (lin(0.0, 0.9), True),
        "Sharpness": (lin(0.0, 0.9), True),
        "ShearX": (lin(0.0, 0.3), True),
        "ShearY": (lin(0.0, 0.3), True),
        "Cutout": (lin(0, 40), False),
        "TranslateX": (lin(0.0, 150.0 / 336.0 * w), True),
        "TranslateY": (lin(0.0, 150.0 / 336.0 * h), True),
        "Grayscale": (zero, False),
        "ChromaDrop": (zero, False),
        "AutoSaturation": (zero, False),
        "Rotate90": (np.full(num_bins, 90.0), True),
    }


def _make_rgb_op(name: str, mag: float, signed: bool, fill: float):
    """Batched op ``(img (n, 3, H, W) float32 [0, 255], sign, cut_ch,
    cut_cw, drop) -> img``, the draws (n,) each.  Mirrors ``_apply_op``
    (``custom_transforms.py:126-218``) through the JAX ``_make_rgb_op``."""

    def op(img, sign, cut_ch, cut_cw, drop):
        m = mag * sign if signed else torch.full_like(sign, mag)
        if name == "Identity":
            return img
        if name == "AutoContrast":
            lo = img.amin(dim=(-2, -1), keepdim=True)
            hi = img.amax(dim=(-2, -1), keepdim=True)
            scale = _scalar(255.0, img) / torch.clamp(hi - lo, min=1e-6)
            return torch.where(hi > lo, _clamp((img - lo) * scale), img)
        if name == "Equalize":
            return _equalize(img)
        if name == "Invert":
            return 255.0 - img
        if name in ("Rotate", "Rotate90"):
            if mag == 0.0:
                return img
            return split_by_sign(sign, lambda s, x: (rotate_image(x, s * mag, "nearest", fill),),
                                 img)[0]
        if name == "Posterize":
            bits = int(mag)
            mask = 256 - 2 ** (8 - bits) if bits < 8 else 255
            return (torch.clamp(img, 0, 255).to(torch.int32) & mask).to(torch.float32)
        if name == "Solarize":
            return torch.where(img >= mag, 255.0 - img, img)
        if name == "SolarizeAdd":
            return torch.where(img < 128.0, _clamp(img + _per_sample(m)), img)
        if name == "Color":
            return _blend(img, _grayscale(img), 1.0 + m)
        if name == "Contrast":
            # an exact sum of integers, then a true division
            gray = torch.round(_grayscale(img))
            mean = gray.sum(dim=(1, 2, 3), keepdim=True) / _scalar(gray[0].numel(), img)
            return _blend(img, mean, 1.0 + m)
        if name == "Brightness":
            return _blend(img, torch.zeros_like(img), 1.0 + m)
        if name == "Sharpness":
            return _blend(img, _smooth(img), 1.0 + m)
        if name in ("ShearX", "ShearY"):
            if mag == 0.0:
                return img
            deg = float(np.degrees(np.arctan(mag)))
            dx = name == "ShearX"

            def shear(s, x):
                d = s * deg
                return (shear_image(x, deg_x=d if dx else 0.0, deg_y=0.0 if dx else d,
                                    fill=fill),)

            return split_by_sign(sign, shear, img)[0]
        if name in ("TranslateX", "TranslateY"):
            t = int(mag)
            dim = 3 if name == "TranslateX" else 2
            return split_by_sign(sign, lambda s, x: (_translate(x, s * t, dim, fill),), img)[0]
        if name == "Cutout":
            return _cutout(img, int(mag), cut_ch, cut_cw, fill)
        if name == "Grayscale":
            return _grayscale(img).expand_as(img).contiguous()
        if name == "ChromaDrop":
            ycc = _to_ycbcr(img)
            drop = drop.to(torch.bool).reshape(-1, 1, 1)
            neutral = _scalar(128.0, img)
            ycc[:, 1] = torch.where(drop, neutral, ycc[:, 1])
            ycc[:, 2] = torch.where(~drop, neutral, ycc[:, 2])
            return _clamp(_from_ycbcr(ycc))
        if name == "AutoSaturation":
            ycc = _to_ycbcr(img)
            c = ycc[:, 1:]
            lo = c.amin(dim=(1, 2, 3), keepdim=True)
            hi = c.amax(dim=(1, 2, 3), keepdim=True)
            ycc[:, 1:] = torch.where(hi > lo, (c - lo) / (hi - lo) * 255.0, c)
            return _clamp(_from_ycbcr(ycc))
        raise ValueError(f"Unknown RGB augmentation op: {name}")

    return op


@dataclasses.dataclass
class RandAugmentRGB:
    """Batched big_vision RandAugment on pixels (``custom_transforms.py:
    222-314``): ``num_ops`` rounds a sample, each an op drawn uniformly from
    ``ops_list`` at the fixed ``magnitude`` of the 11-bin table, its sign
    random for signed ops."""

    ops_list: list[str]
    num_ops: int = 2
    magnitude: int = 10
    num_magnitude_bins: int = 11
    image_hw: tuple[int, int] = (224, 224)
    fill: float = 0.0

    def __post_init__(self):
        table = _rgb_magnitude_table(self.num_magnitude_bins, self.image_hw)
        unknown = [o for o in self.ops_list if o not in table]
        if unknown:
            raise ValueError(f"Unknown ops: {unknown}")
        self._ops = [_make_rgb_op(name, float(table[name][0][self.magnitude]), table[name][1],
                                  self.fill) for name in self.ops_list]
        self._signed = torch.tensor([table[o][1] for o in self.ops_list], dtype=torch.bool)

    def draw_policy(self, generator: torch.Generator, batch: int):
        """``(idx, sign, cut_ch, cut_cw, drop)``, each (batch, num_ops), on
        the generator's device: the op index (int32, uniform), its sign
        (float32, -1 only for signed ops), the Cutout centre (int32, any
        pixel of ``image_hw``) and ChromaDrop's bit (bool: set drops Cb)."""
        dev, n = generator.device, len(self.ops_list)
        if not n:
            raise ValueError("an empty op list draws no policy")
        h, w = self.image_hw
        shape = (batch, self.num_ops)
        idx = torch.randint(0, n, shape, generator=generator, device=dev)
        flip_sign = torch.rand(shape, generator=generator, device=dev) < 0.5
        sign = torch.where(flip_sign & self._signed.to(dev)[idx], -1.0, 1.0)
        cut_ch = torch.randint(0, h, shape, generator=generator, device=dev)
        cut_cw = torch.randint(0, w, shape, generator=generator, device=dev)
        drop = torch.rand(shape, generator=generator, device=dev) < 0.5
        return (idx.to(torch.int32), sign, cut_ch.to(torch.int32), cut_cw.to(torch.int32), drop)

    def apply(self, img: torch.Tensor, policy) -> torch.Tensor:
        """``policy`` (:meth:`draw_policy`) on img (B, 3, H, W) float32 [0,
        255]: each round runs every sample's drawn op, grouped by op."""
        if not self.ops_list:
            return img
        idx, sign, cut_ch, cut_cw, drop = (torch.as_tensor(p).to(img.device) for p in policy)
        for r in range(idx.shape[1]):
            nxt = img.clone()
            for i, op in enumerate(self._ops):
                sel = (idx[:, r] == i).nonzero()[:, 0]
                if sel.numel():
                    nxt[sel] = op(img[sel], sign[sel, r], cut_ch[sel, r], cut_cw[sel, r],
                                  drop[sel, r])
            img = nxt
        return img


# -------------------------------------------------------------- pipelines --
class RgbTrainPipeline:
    """RandomResizedCrop -> HFlip -> RandAugment -> ToTensor_range(-1, 1) on
    pixel canvases (the ``imagenet`` / ``imagenet_swin`` train chains,
    ``datasets.py:317-343``; both pass ``fill=128`` to RandAugment), the
    JAX ``make_rgb_train_pipeline``.  ``pipe(pixels, flip, policy, crop)``
    takes the (B, 3, canvas, canvas) pixels (uint8, or float32 from the
    device decode) and the draws; ``pipe.draw(generator, batch)`` makes them:
    the crop boxes, the flip bits, the policy."""

    def __init__(self, size: int, canvas: int, auglist, num_ops: int, magnitude: int,
                 fill: float = 128.0):
        self.rrc = RandomResizedCropRGB(size, canvas)
        self.aug = RandAugmentRGB(ops_list=list(auglist or []), num_ops=num_ops,
                                  magnitude=magnitude, image_hw=(size, size), fill=fill)

    def draw(self, generator: torch.Generator, batch: int):
        crop = self.rrc.draw(generator, batch)
        flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return flip, self.aug.draw_policy(generator, batch), crop

    def __call__(self, pixels: torch.Tensor, flip, policy, crop) -> torch.Tensor:
        img = self.rrc.crop(pixels.to(torch.float32), crop)
        img = flip_images(img, flip)
        return to_unit_range(self.aug.apply(img, policy))


def flip_images(img: torch.Tensor, flip) -> torch.Tensor:
    """Horizontal flip of the samples whose ``flip`` bit is set."""
    sel = torch.as_tensor(flip).to(device=img.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(sel, torch.flip(img, dims=(-1,)), img)


def make_rgb_train_pipeline(cfg=None, *, size: int = 224, canvas: int = 512, auglist=None,
                            num_ops: int = 2, magnitude: int = 10,
                            fill: float = 128.0) -> RgbTrainPipeline:
    """The full-canvas RGB train pipeline; ``cfg`` supplies the input size,
    the op list, the number of rounds and the magnitude."""
    if cfg is not None:
        size, auglist = cfg.model.input_size, list(cfg.train.auglist)
        num_ops, magnitude = cfg.train.num_ops, cfg.train.augstr
    return RgbTrainPipeline(size, canvas, auglist, num_ops, magnitude, fill)


def make_rgb_eval_pipeline(cfg=None, *, size: int = 224, resize_to: int = 256,
                           canvas: int = 512):
    """Resize(256) + CenterCrop(224) (ViT) or the whole canvas resized
    (SwinV2, ``datasets.py:347``), then [-1, 1]: ``fn(pixels) -> img``."""
    if cfg is not None:
        size = cfg.model.input_size
        if cfg.model.arch == "swinv2":
            resize_to = size
    rcc = make_resize_center_crop_rgb(resize_to, size, canvas)
    return lambda pixels: to_unit_range(rcc(pixels.to(torch.float32)))

