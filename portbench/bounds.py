"""The card's peaks and the least time of each measured layer's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s for bf16 and fp16 products, 495 for TF32 (the highest rate for a
product of float32 operands, so a float32-faithful implementation such as
3xTF32 never reads above it), 67 for float32 on the CUDA cores, 3.35 TB/s
of HBM.  A roofline share is the least time, the larger of operations over
the peak and bytes over the bandwidth, over the device time the layer took;
each input byte is counted read once and each output byte written once.
The operation and byte counts are those of the port's smoke test
(``chip_smoke.py``: ``attention_bound_ms``, the backward's, ``window_bounds_ms``,
the wire reader's), taken at the shapes a configuration fixes.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FLOP_PER_S", "attention_bound_s", "augpipe_bound_s",
           "peak_flop_per_s", "vit_attention_calls", "window_attention_calls",
           "window_bound_s"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "fp16": 989e12, "float32": 495e12}
PEAK_F32_CUDA_CORES = 67e12


def peak_flop_per_s(dtype: str) -> float:
    """The product peak of operands of ``dtype`` (float32 -> TF32's)."""
    return PEAK_FLOP_PER_S[dtype]


def _bound(flop: float, nbytes: float, peak: float) -> float:
    return max(flop / peak, nbytes / PEAK_BYTES_PER_S)


def attention_bound_s(b: int, h: int, n: int, d: int, dtype: str, backward: bool) -> float:
    """softmax(scale QKᵀ) V for (b, h, n, d) operands of ``dtype``: the
    forward reads q, k, v and writes o (4 N² D FLOP a head); the backward
    reads q, k, v, o, dO and the row log-sum-exp and writes dq, dk, dv
    (10 N² D)."""
    es = 2 if dtype in ("bf16", "fp16") else 4
    qkv = b * h * n * d
    if backward:
        return _bound(10 * n * n * d * b * h, 8 * qkv * es + b * h * n * 4,
                      peak_flop_per_s(dtype))
    return _bound(4 * n * n * d * b * h, 4 * qkv * es, peak_flop_per_s(dtype))


def window_bound_s(bw: int, h: int, n: int, d: int, patterns: int, backward: bool) -> float:
    """Window attention on float32 q, k, v (bw, h, n, d) with a (patterns,
    h, n, n) bias: the forward reads q, k, v and the bias and writes o (4 N²
    D FLOP a window and head); the backward reads q, k, v, dO and the bias
    and writes dq, dk, dv and the bias gradient (10 N² D)."""
    qkv = bw * h * n * d * 4
    bias = patterns * h * n * n * 4
    if backward:
        return _bound(10 * n * n * d * bw * h, 7 * qkv + 2 * bias, peak_flop_per_s("float32"))
    return _bound(4 * n * n * d * bw * h, 4 * qkv + bias, peak_flop_per_s("float32"))


def augpipe_bound_s(read_bytes: int, batch: int, grid: int, rounds: int) -> float:
    """The wire reader's stage: the rows' wire bytes read, float32 y (B, 1,
    G, G, 8, 8) and c (B, 2, G/2, G/2, 8, 8) written; per coefficient the
    decode, the entry clamp and the rescale (8 FLOP) and 3 a round, on the
    CUDA cores."""
    elements = batch * 64 * (grid * grid + 2 * (grid // 2) ** 2)
    return max((read_bytes + 4 * elements) / PEAK_BYTES_PER_S,
               elements * (8 + 3 * rounds) / PEAK_F32_CUDA_CORES)


def vit_attention_calls(model: dict, batch: int) -> list[tuple]:
    """(b, h, n, d) of each attention call of one ViT forward: one a block,
    at the embedding's token count."""
    tokens = (model["dct_blocks"] * 8 // model["patch_size"]) ** 2
    return [(batch, model["heads"], tokens, model["head_size"])] * model["depth"]


def window_attention_calls(model: dict, batch: int) -> list[tuple]:
    """(bw, h, n, d, patterns) of each window attention call of one SwinV2
    forward: even blocks unshifted (one bias pattern), odd ones shifted (one
    pattern a window), a stage no larger than the window unshifted."""
    res = model["dct_blocks"] * 8 // 4
    ws, emb = model["window_size"], model["embed_size"]
    calls = []
    for i, (depth, heads) in enumerate(zip(model["depth"], model["heads"])):
        r = res // 2 ** i
        w = min(ws, r)
        wins = (r // w) ** 2
        dim = emb * 2 ** i
        for blk in range(depth):
            shifted = blk % 2 == 1 and r > ws
            calls.append((batch * wins, heads, w * w, dim // heads, wins if shifted else 1))
    return calls
