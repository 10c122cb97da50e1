"""Everything a run feeds the program, made from ``--seed``: the wire rows,
each step's draws, and the model's weights.

The rows are seeded coefficient planes with the fall-off of magnitude with
frequency and the occupancy that the traffic's ``spectrum`` states, packed
by the configuration's wire module (``wires/<transfer>.<format>.py``) as the
host codec packs them.  They are made on the device in a few large calls
and kept on the host, where a loader would leave them.
The draws (flip, RandAugment policy, mixup lambda, SwinV2's drop-path keep
masks) follow the port's draw rules and come from a host generator.  The
weights are one normal draw on the device for every parameter, scaled per
leaf by its kind.  The same seed gives the same rows, draws and weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.augment import CHROMA, SIGNED

__all__ = ["make_draws", "make_rows", "make_weights", "stream_seed"]

_STREAMS = {"rows": 1, "weights": 2, "draws": 3, "mixup": 4}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one of the run's random streams."""
    seq = np.random.SeedSequence([seed & (2**64 - 1), _STREAMS[stream]])
    return int(seq.generate_state(1, np.uint64)[0]) >> 1


SPECTRUM_KEYS = {"ac_amplitude", "ac_falloff", "ac_nonzero", "dc_half_range"}


def _planes(gen: torch.Generator, n: int, grid: int, device, spectrum: dict):
    """Dequantized coefficient planes y (n, 1, G, G, 8, 8) and c (n, 2, G/2,
    G/2, 8, 8) in [-1024, 1016] with the traffic's ``spectrum``: the AC at
    frequency (u, v) normal with amplitude ``ac_amplitude`` / (1 +
    ``ac_falloff`` (u + v)), non-zero with probability ``ac_nonzero``; DCs
    uniform in [-``dc_half_range``, ``dc_half_range``)."""
    if set(spectrum) != SPECTRUM_KEYS:
        raise ValueError(f"a spectrum has the keys {sorted(SPECTRUM_KEYS)}, not "
                         f"{sorted(spectrum)}")
    freq = torch.arange(8, device=device)[:, None] + torch.arange(8, device=device)[None, :]
    amp = spectrum["ac_amplitude"] / (1.0 + spectrum["ac_falloff"] * freq.float())
    dc_span = 2.0 * spectrum["dc_half_range"]

    def plane(shape):
        x = torch.randn(shape + (8, 8), generator=gen, device=device) * amp
        x = x * (torch.rand(shape + (8, 8), generator=gen, device=device)
                 < spectrum["ac_nonzero"])
        x[..., 0, 0] = (torch.rand(shape, generator=gen, device=device) * dc_span
                        - spectrum["dc_half_range"])
        return x.clamp(-1024.0, 1016.0)

    return plane((n, 1, grid, grid)), plane((n, 2, grid // 2, grid // 2))


def make_rows(seed: int, batches: int, batch: int, grid: int, k: int, classes: int,
              device, spectrum: dict, encode) -> list[np.ndarray]:
    """``batches`` batches of (batch, row) uint8 wire rows on the host: planes
    of the traffic's ``spectrum``, labels uniform over ``classes``, packed by
    the wire module's ``encode(y, c, labels, k)``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "rows"))
    out = []
    for _ in range(batches):
        y, c = _planes(gen, batch, grid, device, spectrum)
        labels = torch.randint(0, classes, (batch,), generator=gen, device=device,
                               dtype=torch.int32)
        out.append(encode(y, c, labels, k).cpu().numpy())
    return out


def make_draws(gen: torch.Generator, rng: np.random.Generator, batch: int, grid: int,
               ops_list: list, num_ops: int, mixup_alpha: float,
               drop_path_rates: list | None) -> dict:
    """The next step's draws, ``{"flip": (B,) bool, "policy": (idx, sign,
    cut_ch, cut_cw, drop) each (B, rounds), "lam": float, "drop_keep":
    (blocks, 2, B) bool or None}``: each sample flips with probability 1/2; each
    round draws an op uniformly from those still allowed (Grayscale and the
    chroma ops exclude each other for the rest of the sample's rounds), a
    sign (-1 with probability 1/2, signed ops only), an even cutout centre
    and ChromaDrop's channel bit; lambda is the larger of u and 1 - u for
    u ~ Beta(alpha, alpha); block i keeps each sample's branch with
    probability 1 - rate_i."""
    flip = torch.rand(batch, generator=gen) < 0.5
    n = len(ops_list)
    signed = torch.tensor([o in SIGNED for o in ops_list])
    chroma = torch.tensor([o in CHROMA and o != "Grayscale" for o in ops_list])
    gray = torch.tensor([o == "Grayscale" for o in ops_list])
    allowed = torch.ones((batch, n), dtype=torch.bool)
    cols = []
    for _ in range(num_ops):
        allowed = allowed | ~allowed.any(dim=1, keepdim=True)
        idx = torch.multinomial(allowed.float(), 1, generator=gen)[:, 0]
        neg = torch.rand(batch, generator=gen) < 0.5
        sign = torch.where(neg & signed[idx], -1.0, 1.0)
        cut_ch = torch.randint(0, grid, (batch,), generator=gen) // 2 * 2
        cut_cw = torch.randint(0, grid, (batch,), generator=gen) // 2 * 2
        drop = torch.rand(batch, generator=gen) < 0.5
        allowed = torch.where(gray[idx][:, None], allowed & ~(chroma | gray), allowed)
        allowed = torch.where(chroma[idx][:, None], allowed & ~gray, allowed)
        cols.append((idx.int(), sign, cut_ch.int(), cut_cw.int(), drop))
    policy = tuple(torch.stack(col, dim=1) for col in zip(*cols))
    u = np.float32(rng.beta(mixup_alpha, mixup_alpha))
    lam = float(max(u, np.float32(1.0) - u))
    keep = None
    if drop_path_rates is not None:
        r = torch.rand((len(drop_path_rates), 2, batch), generator=gen)
        keep = r >= torch.tensor(drop_path_rates, dtype=r.dtype)[:, None, None]
    return {"flip": flip, "policy": policy, "lam": lam, "drop_keep": keep}


def _leaf_kinds(model: torch.nn.Module) -> dict[str, str]:
    kinds = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.LayerNorm):
            kinds[f"{name}.weight"], kinds[f"{name}.bias"] = "norm_weight", "small"
    for name, p in model.named_parameters():
        if name.endswith("logit_scale"):
            kinds[name] = "logit_scale"
        elif name not in kinds:
            kinds[name] = "matrix" if p.dim() == 2 else "small"
    return kinds


@torch.no_grad()
def make_weights(seed: int, model: torch.nn.Module, device) -> dict[str, torch.Tensor]:
    """Weights for every parameter of ``model`` (names and shapes; it may sit
    on the meta device): one normal draw on ``device`` for all of them, then
    per leaf: matrices N(0, 1 / fan_in); LayerNorm scales 1 + 0.02 N; cosine
    attention's logit scale log 10 + 0.02 N; biases and other vectors
    0.02 N."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    named = [(n, p.shape) for n, p in model.named_parameters()]
    kinds = _leaf_kinds(model)
    flat = torch.randn(sum(math.prod(s) for _, s in named), generator=gen, device=device)
    out, off = {}, 0
    for name, shape in named:
        size = math.prod(shape)
        v = flat[off:off + size].view(shape)
        off += size
        kind = kinds[name]
        if kind == "matrix":
            v = v * (1.0 / math.sqrt(shape[1]))
        elif kind == "norm_weight":
            v = 1.0 + 0.02 * v
        elif kind == "logit_scale":
            v = math.log(10.0) + 0.02 * v
        else:
            v = 0.02 * v
        out[name] = v
    return out
