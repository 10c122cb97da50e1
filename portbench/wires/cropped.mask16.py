"""The cropped transfer's ``mask16`` wire: what the rows hold, how the
traffic packs them, and what they mean to the plain reference.

One row a sample: for every 8x8 block of the luma grid (G x G) and of the
two chroma grids (G/2 x G/2) its K largest ACs as int8 over a per-block
scale, an 8-byte mask of the positions they sit at, the scale, the exact
int16 DC; then the quantisation tables, the label and the sample's weight.
The port's ``Trainer`` takes it as ``transfer="cropped"``, format
``mask16``, at the configuration's K.

Found by name: a configuration's ``wire`` section names the transfer and the
format, and the harness loads ``wires/<transfer>.<format>.py``.  A wire
module gives ``trainer_options``, ``loader_batch``, ``encode``,
``read_bytes`` and ``decode``; nothing in it imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["decode", "encode", "fields", "layout", "loader_batch", "read_bytes",
           "trainer_options"]

KEYS = {"transfer", "format", "train_k", "eval_k"}


def trainer_options(wire: dict) -> dict:
    """The port's ``Trainer`` options for this wire."""
    if set(wire) != KEYS:
        raise ValueError(f"the cropped mask16 wire takes the keys {sorted(KEYS)}, "
                         f"not {sorted(wire)}")
    return {"transfer": "cropped", "packed_k": wire["train_k"],
            "packed_k_eval": wire["eval_k"], "train_fmt": "mask16", "eval_fmt": "mask16"}


def loader_batch(rows: np.ndarray) -> dict:
    """A loader's batch of these rows, as ``Trainer.upload`` takes it."""
    return {"packed": rows}


def layout(grid: int, k: int) -> dict:
    """Byte layout of one row on a ``grid`` x ``grid`` block grid with ``k``
    ACs a block: field -> (offset, per-sample shape, numpy dtype), and
    ``"row"`` -> the row's bytes.  Every offset and the row are 4-aligned."""
    half = grid // 2
    spec = [("vy", (1, grid, grid, k), np.int8), ("iy", (1, grid, grid, 8), np.uint8),
            ("sy", (1, grid, grid), np.uint8), ("vc", (2, half, half, k), np.int8),
            ("ic", (2, half, half, 8), np.uint8), ("sc", (2, half, half), np.uint8),
            ("quant", (3, 8, 8), np.int16), ("labels", (), np.int32),
            ("weights", (), np.float32), ("dy", (1, grid, grid), np.int16),
            ("dc", (2, half, half), np.int16)]
    out, off = {}, 0
    for name, shape, dtype in spec:
        off = (off + 3) // 4 * 4
        out[name] = (off, shape, np.dtype(dtype))
        off += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    out["row"] = (off + 3) // 4 * 4
    return out


_TORCH = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
          np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}


def _pack_blocks(blocks: torch.Tensor, k: int):
    """The mask16 packing of (n, 64) blocks: (values (n, k) int8, mask (n, 8)
    uint8, scale (n,) uint8, dc (n,) int16): the exact DC; the ACs' scale
    ceil(max |AC| / 127); the K largest quantised magnitudes, in position
    order, where non-zero."""
    n = blocks.shape[0]
    dc = torch.round(blocks[:, 0]).clamp(-32768, 32767).to(torch.int16)
    ac = blocks[:, 1:]
    mag = ac.abs()
    scale = torch.ceil(mag.amax(dim=1) / 127.0).clamp(1, 255)
    q = torch.clamp((mag * (1.0 / scale)[:, None] + 0.5).to(torch.int32), max=127)
    top = torch.sort(-q, dim=1, stable=True).indices[:, :k]
    keep = torch.zeros_like(q, dtype=torch.bool).scatter_(1, top, True) & (q > 0)
    slot = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    r, col = keep.nonzero(as_tuple=True)
    values = torch.zeros((n, k), dtype=torch.int8, device=blocks.device)
    values[r, slot[r, col].long()] = torch.where(ac[r, col] < 0, -q[r, col], q[r, col]).to(
        torch.int8)
    bits = torch.zeros((n, 64), dtype=torch.int32, device=blocks.device)
    bits[:, 1:] = keep
    weights = 2 ** torch.arange(8, device=blocks.device, dtype=torch.int32)
    mask = (bits.reshape(n, 8, 8) * weights).sum(-1).to(torch.uint8)
    return values, mask, scale.to(torch.uint8), dc


def encode(y: torch.Tensor, c: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(B, row) uint8 rows, on ``y``'s device, of dequantised coefficient
    planes y (B, 1, G, G, 8, 8) and c (B, 2, G/2, G/2, 8, 8), int32
    ``labels``, weights 1 and quantisation tables 1."""
    batch, grid = y.shape[0], y.shape[2]
    lay = layout(grid, k)
    rows = torch.zeros((batch, lay["row"]), dtype=torch.uint8, device=y.device)

    def put(name, value):
        off, shape, dtype = lay[name]
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        rows[:, off:off + nbytes].view(value.dtype)[:] = value.reshape(batch, -1)

    for tag, plane in (("y", y), ("c", c)):
        vals, mask, scale, dc = _pack_blocks(plane.reshape(-1, 64), k)
        put(f"v{tag}", vals)
        put(f"i{tag}", mask)
        put(f"s{tag}", scale)
        put(f"d{tag}", dc)
    put("quant", torch.ones((batch, 3 * 64), dtype=torch.int16, device=y.device))
    put("labels", labels.to(torch.int32))
    put("weights", torch.ones(batch, dtype=torch.float32, device=y.device))
    return rows


def read_bytes(rows: np.ndarray, grid: int, k: int) -> int:
    """The wire bytes a reader must read for these rows: per block its
    8-byte mask, its scale, its int16 DC and the values of its first
    min(set bits, K) slots."""
    lay = layout(grid, k)
    total = 0
    for tag in ("y", "c"):
        off, shape, _ = lay[f"i{tag}"]
        nbytes = int(np.prod(shape))
        masks = rows[:, off:off + nbytes].reshape(-1, 8)
        set_bits = np.unpackbits(masks, axis=-1).sum(axis=-1)
        total += set_bits.size * (8 + 1 + 2) + int(np.minimum(set_bits, k).sum())
    return total


def fields(rows: torch.Tensor, grid: int, k: int) -> dict[str, torch.Tensor]:
    """The typed fields of (B, row) uint8 rows, copied out of the rows."""
    lay = layout(grid, k)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != lay["row"]:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype} do not fit the layout")
    out = {}
    for name, (off, shape, dtype) in ((n, s) for n, s in lay.items() if n != "row"):
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        part = rows[:, off:off + nbytes].contiguous().view(_TORCH[dtype])
        out[name] = part.reshape((rows.shape[0],) + shape)
    return out


def _unpack(values: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
            dc: torch.Tensor) -> torch.Tensor:
    """Dense (..., 8, 8) coefficients of mask16 blocks: the value of set
    position p sits in slot popcount(bits below p) times the block's scale;
    a set bit past the K slots has no value; the exact int16 DC goes to
    position 0."""
    k = values.shape[-1]
    shifts = torch.arange(8, device=mask.device, dtype=torch.int32)
    bits = ((mask.to(torch.int32)[..., None] >> shifts) & 1).reshape(mask.shape[:-1] + (64,))
    rank = torch.cumsum(bits, dim=-1) - bits
    vals = values.to(torch.float32) * scale.to(torch.float32)[..., None]
    dense = torch.gather(vals, -1, rank.clamp(max=k - 1).to(torch.int64))
    dense = torch.where((bits == 1) & (rank < k), dense, torch.zeros_like(dense))
    dense[..., 0] = dc.to(torch.float32)
    return dense.reshape(dense.shape[:-1] + (8, 8))


def decode(rows: torch.Tensor, grid: int, k: int):
    """What the rows mean, for the plain reference: (y (B, 1, G, G, 8, 8),
    c (B, 2, G/2, G/2, 8, 8)) float32 dequantised coefficients, labels,
    weights."""
    f = fields(rows, grid, k)
    return (_unpack(f["vy"], f["iy"], f["sy"], f["dy"]),
            _unpack(f["vc"], f["ic"], f["sc"], f["dc"]), f["labels"], f["weights"])
