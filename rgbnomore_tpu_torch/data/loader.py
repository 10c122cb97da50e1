"""Threaded DCT loaders: JPEG -> coefficient canvases or consolidated uint8
row batches.

The port's copy of ``rgbnomore_tpu/data/loader.py``: ``_BaseLoader``,
``_check_chroma_grid``, ``packed_layout``, ``row_views``, the three DCT
loaders of the JAX Trainer's transfers:

- ``DctCroppedLoader`` (``transfer="cropped"``): the host crops and
  resizes, rows of the target grid in the mask16 family;
- ``DctPackedLoader`` (``"packed"``): the whole image's top-K coefficients
  on a 64-block canvas, rows in the ``mask``, ``index`` or mask16 formats;
- ``DctCanvasLoader`` (``"dense"``): dense int16 quantized coefficient
  planes on the canvas, with the quant tables, labels and weights;

and the two of the RGB domain: ``RgbCroppedLoader`` (``"cropped"``: the
pixel-granular crop box's covering window in a fixed mask16 row with its
residual box, ``geom``) and ``RgbCanvasLoader`` (``"dense"``: decoded uint8
pixels on a canvas).  The RGB ``"packed"`` transfer takes
``DctPackedLoader``'s mask16 rows of the whole image at K=63.

For the same files, seed and mode each writes what the JAX package's loader
writes, byte for byte (``tests/test_torch_port_eval.py``,
``tests/test_torch_port_transfers.py``).

The host's only job in the hot path is the libjpeg Huffman decode (plus the
crop, resize and pack of ``codec.read_crop_resize_pack_row``), which
releases the GIL, so a thread pool decodes in parallel and a background
thread keeps a small queue of ready batches ahead of the consumer.  The
producer's decode of each batch is the span ``rgbnm.loader.decode`` and the
consumer's wait for it ``rgbnm.loader.wait``, both with the batch's index in
the iteration; ``rgbnm.loader.batches`` counts the batches handed over and
``rgbnm.loader.starved`` those the consumer found not ready.

Sharding: each loader takes ``(shard_id, num_shards)`` and reads only its
strided slice — train shards rebalance per epoch with the shuffle; eval uses
the strided rank slicing of the reference's no-padding
``DistributedEvalSampler`` (``utils/custom_sampler.py:53-104``), with padding
expressed as zero weights instead of dropped examples.
"""

from __future__ import annotations

import functools
import itertools
import queue
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rgbnomore_tpu_torch.data.index import IndexDataset
from rgbnomore_tpu_torch.utils import profiling

__all__ = ["DctCanvasLoader", "DctCroppedLoader", "DctPackedLoader", "RgbCanvasLoader",
           "RgbCroppedLoader", "packed_layout", "row_views"]


class _BaseLoader:
    def __init__(
        self,
        dataset: IndexDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        num_threads: int = 4,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch (reference: ``sampler.set_epoch``)."""
        self.epoch = epoch

    def _shard_len(self) -> int:
        """Per-shard sample count; identical on every shard (padded)."""
        n = len(self.dataset)
        return (n + self.num_shards - 1) // self.num_shards

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
            # pad to equal shards like DistributedSampler (datasets.py:533-535)
            pad = (-len(order)) % self.num_shards
            if pad:
                order = np.concatenate([order, order[:pad]])
            return order[self.shard_id :: self.num_shards]
        # eval: strided rank slicing (custom_sampler.py:88), padded with -1
        # sentinels (weight 0) so every shard runs the SAME number of batches
        idx = np.arange(n)[self.shard_id :: self.num_shards]
        pad = self._shard_len() - len(idx)
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, idx.dtype)])
        return idx

    def __len__(self) -> int:
        """Batches per shard per epoch; cheap (no permutation materialized)."""
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        raise NotImplementedError

    def _iterate(self, total_batches: int | None, cycle: bool):
        if cycle and len(self) == 0:
            # with drop_last a shard smaller than one batch yields ZERO
            # batches per epoch; cycling would spin forever producing nothing
            raise ValueError(
                f"cannot cycle over an empty loader: shard has "
                f"{self._shard_len()} examples < batch_size={self.batch_size} "
                f"(drop_last)"
            )
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Put with stop polling so an abandoned consumer never strands
            the producer inside a full queue (leaking thread + batches)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            produced = 0
            with ThreadPoolExecutor(self.num_threads) as pool:
                while True:
                    indices = self._epoch_indices()
                    nb = len(self)
                    for b in range(nb):
                        if stop.is_set():
                            return
                        if total_batches is not None and produced >= total_batches:
                            put_or_stop(None)
                            return
                        lo = b * self.batch_size
                        batch_idx = indices[lo : lo + self.batch_size]
                        try:
                            with profiling.span("rgbnm.loader.decode", produced):
                                batch = self._decode_batch(pool, batch_idx, b)
                            if not put_or_stop(batch):
                                return
                        except Exception as exc:  # surface decode errors
                            put_or_stop(exc)
                            return
                        produced += 1
                    if not cycle:
                        put_or_stop(None)
                        return
                    self.epoch += 1  # continuous mode: advance the shuffle

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for consumed in itertools.count():
                if out_q.empty():
                    profiling.count("rgbnm.loader.starved")
                with profiling.span("rgbnm.loader.wait", consumed):
                    item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                profiling.count("rgbnm.loader.batches")
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self._iterate(None, cycle=False)

    def iter_cycle(self, total_batches: int):
        """Continuous multi-epoch iteration without producer restarts."""
        return self._iterate(total_batches, cycle=True)


def _check_chroma_grid(path, ncomp: int, yh: int, yw: int, ch: int, cw: int):
    """Fail loudly on non-4:2:0 color JPEGs instead of silently garbling.

    Every coefficient consumer here (and in the reference, whose loaders
    return Y (1,h,w,8,8) / CbCr (2,h/2,w/2,8,8), ``datasets.py:286-297``)
    assumes 2x2-subsampled chroma; 4:4:4/4:2:2 inputs would decode with the
    chroma plane stretched.
    """
    if ncomp == 3 and (ch != (yh + 1) // 2 or cw != (yw + 1) // 2):
        raise ValueError(
            f"{path}: chroma block grid {ch}x{cw} does not match 4:2:0 for "
            f"luma {yh}x{yw}. Re-stage the dataset as 4:2:0 JPEGs."
        )


PACKED_FORMATS = ("mask", "index", "mask16", "mask16w", "mask16q")


@functools.lru_cache(maxsize=32)
def packed_layout(canvas: int, k: int, fmt: str = "mask16",
                  geom: bool = False) -> types.MappingProxyType:
    """Per-SAMPLE byte layout of the consolidated packed row, built once per
    arguments and shared read-only.

    All per-sample fields live in one uint8 row so a whole batch transfers as
    a single ``(B, row_bytes)`` buffer.  Returns field -> (byte_offset,
    per-sample shape, dtype) plus ``"row"`` -> row bytes.

    ``fmt="mask"``: top-K int8 values a block with a uint8 scale, positions
    in an 8-byte/block occupancy bitmask (``iy``/``ic`` shaped (..., 8)) —
    25 B/block at K=16.  ``fmt="index"``: one uint8 position per value
    (``iy``/``ic`` shaped (..., K)) — 33 B/block.  ``fmt="mask16"``: like
    ``mask`` plus exact int16 DC planes ``dy``/``dc`` and a DC-free AC scale
    — K+11 B/block.  ``fmt="mask16w"``: int16 AC values (scale pinned 1) —
    2K+11 B/block.  ``fmt="mask16q"``: the mask16 layout carrying JPEG
    *quantized-unit* integers that the device multiplies back by the quant
    table.  ``geom`` adds the RGB cropped wire's residual resample box
    ``geom`` (4,) float32: sy0, sh, sx0, sw in the downsampled window's
    pixels (``codec.read_rgb_crop_pack_row``).  Offsets are 4-aligned, so
    every field can be viewed as its dtype in place.
    """
    if fmt not in PACKED_FORMATS:
        raise ValueError(f"unknown packed wire format {fmt!r}")
    cv2 = canvas // 2
    iw = k if fmt == "index" else 8  # index / mask bytes per block
    vdt = np.int16 if fmt == "mask16w" else np.int8
    fields = {
        "vy": ((1, canvas, canvas, k), vdt),
        "iy": ((1, canvas, canvas, iw), np.uint8),
        "sy": ((1, canvas, canvas), np.uint8),
        "vc": ((2, cv2, cv2, k), vdt),
        "ic": ((2, cv2, cv2, iw), np.uint8),
        "sc": ((2, cv2, cv2), np.uint8),
        "quant": ((3, 8, 8), np.int16),
        "labels": ((), np.int32),
        "weights": ((), np.float32),
    }
    if fmt.startswith("mask16"):
        fields["dy"] = ((1, canvas, canvas), np.int16)
        fields["dc"] = ((2, cv2, cv2), np.int16)
    if geom:
        fields["geom"] = ((4,), np.float32)
    layout = {}
    off = 0
    for name, (shape, dtype) in fields.items():
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        off = (off + 3) // 4 * 4  # align for int16/int32/float32 views
        layout[name] = (off, shape, np.dtype(dtype))
        off += nbytes
    layout["row"] = (off + 3) // 4 * 4
    return types.MappingProxyType(layout)


def row_views(row: np.ndarray, layout: dict) -> dict[str, np.ndarray]:
    """Writable zero-copy dtype/shape views of ONE contiguous row buffer."""
    out = {}
    for name, spec in layout.items():
        if name == "row":
            continue
        off, shape, dtype = spec
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = np.frombuffer(row, dtype=dtype, count=n, offset=off).reshape(shape)
    return out


class DctCanvasLoader(_BaseLoader):
    """Dense quantized DCT coefficient canvases (the ``"dense"`` transfer):
    each image's blocks at the top left of a ``canvas``-block canvas, zeros
    elsewhere.

    Yields ``{"y": (B, 1, canvas, canvas, 8, 8) int16, "cbcr": (B, 2,
    canvas/2, canvas/2, 8, 8) int16, "quant": (B, 3, 8, 8) int16, "labels":
    (B,) int32, "weights": (B,) float32}`` (weight 0 for padding rows).
    """

    def __init__(self, dataset: IndexDataset, batch_size: int, canvas: int = 64, **kw):
        super().__init__(dataset, batch_size, **kw)
        from rgbnomore_tpu_torch import codec

        self.canvas = canvas
        self._read = codec.read_into_canvas

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        bsz, cv = self.batch_size, self.canvas
        y = np.zeros((bsz, 1, cv, cv, 8, 8), np.int16)
        c = np.zeros((bsz, 2, cv // 2, cv // 2, 8, 8), np.int16)
        quant = np.ones((bsz, 3, 8, 8), np.int16)
        labels = np.zeros((bsz,), np.int32)
        weights = np.zeros((bsz,), np.float32)

        def work(slot: int, ds_index: int):
            if ds_index < 0:  # shard-padding sentinel
                return
            path = self.dataset.paths[ds_index]
            ncomp, yh, yw, ch, cw, *_ = self._read(path, y[slot], c[slot], quant[slot])
            _check_chroma_grid(path, ncomp, yh, yw, ch, cw)
            labels[slot] = self.dataset.labels[ds_index]
            weights[slot] = 1.0

        list(pool.map(lambda args: work(*args), enumerate(idx)))
        return {"y": y, "cbcr": c, "quant": quant, "labels": labels, "weights": weights}


class DctPackedLoader(_BaseLoader):
    """Sparse top-K packed coefficients of the whole image on a
    ``canvas``-block canvas (the ``"packed"`` transfer), ONE consolidated
    (B, row) buffer per batch in a ``packed_layout`` format: ``mask`` (the
    DCT default, 5x fewer bytes than dense int16 at K=16), ``index``, or
    ``mask16`` (exact DCs).  The values are quantized units; the device
    dequantizes.

    Yields ``{"packed": uint8 (B, row), "labels": ..., "weights": ...}``;
    labels/weights are host-side copies for bookkeeping — the device step
    re-slices every field from ``packed``.
    """

    def __init__(self, dataset: IndexDataset, batch_size: int, canvas: int = 64,
                 k: int = 16, fmt: str = "mask", **kw):
        super().__init__(dataset, batch_size, **kw)
        from rgbnomore_tpu_torch import codec

        if fmt not in ("mask", "index", "mask16"):
            raise ValueError(f"the packed loader writes mask, index or mask16, not {fmt!r}")
        self.canvas, self.k, self.fmt = canvas, k, fmt
        self.layout = packed_layout(canvas, k, fmt)
        if fmt == "mask16":
            self._read_views = lambda path, v: codec.read_into_packed_mask16(
                path, k, v["vy"], v["iy"], v["sy"], v["dy"],
                v["vc"], v["ic"], v["sc"], v["dc"], v["quant"])
        else:
            read = codec.read_into_packed_mask if fmt == "mask" else codec.read_into_packed
            self._read_views = lambda path, v: read(
                path, k, v["vy"], v["iy"], v["sy"], v["vc"], v["ic"], v["sc"], v["quant"])

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        buf = np.zeros((self.batch_size, self.layout["row"]), np.uint8)
        labels = np.zeros((self.batch_size,), np.int32)
        weights = np.zeros((self.batch_size,), np.float32)

        def work(slot: int, ds_index: int):
            if ds_index < 0:  # shard-padding sentinel
                return
            v = row_views(buf[slot], self.layout)
            path = self.dataset.paths[ds_index]
            ncomp, yh, yw, ch, cw = self._read_views(path, v)
            _check_chroma_grid(path, ncomp, yh, yw, ch, cw)
            v["labels"][...] = labels[slot] = self.dataset.labels[ds_index]
            v["weights"][...] = weights[slot] = 1.0

        list(pool.map(lambda args: work(*args), enumerate(idx)))
        return {"packed": buf, "labels": labels, "weights": weights}


class DctCroppedLoader(_BaseLoader):
    """Crop-before-pack loader: the host samples the crop box, resizes the
    window to the TARGET grid and ships only ``target^2 (+ 2 chroma)`` blocks
    in the ``mask16`` wire format.

    This matches the reference's data movement order (crop/resize on the CPU
    before anything reaches the accelerator, ``custom_transforms.py:527-669``)
    while keeping the rest of the input pipeline on the device.  Crop boxes
    are sampled on the TRUE image block grid (not a padded canvas).

    ``mode``: ``"train"`` random-resized-crop, ``"center"`` the ViT val
    ResizedCenterCrop (crop ratio ``target/(target+4)``), ``"full"`` the swin
    val whole-image resize.  The wire carries DEQUANTIZED coefficients (or
    quantized units for ``mask16q``) — pair with
    ``augment.pipeline.make_cropped_eval_pipeline``.

    Yields ``{"packed": uint8 (B, row), "labels": ..., "weights": ...}``;
    labels/weights are host-side copies for bookkeeping — the device step
    re-slices every field from ``packed``.
    """

    def __init__(self, dataset: IndexDataset, batch_size: int, target: int = 28,
                 k: int = 16, mode: str = "train",
                 scale: tuple[float, float] = (0.05, 1.0),
                 center_ratio: float | None = None, max_src: int = 64,
                 fmt: str = "mask16", **kw):
        super().__init__(dataset, batch_size, **kw)
        # imported here, not at the top: the codec builds against libjpeg,
        # and the device side imports packed_layout from this module on
        # machines that have no libjpeg
        from rgbnomore_tpu_torch import codec
        from rgbnomore_tpu_torch.data.croppack import build_op_pack

        if fmt not in ("mask16", "mask16w", "mask16q"):
            raise ValueError(f"unknown crop wire format {fmt!r}")
        if mode not in ("train", "center", "full"):
            raise ValueError(f"unknown crop mode {mode!r}")
        self.target = target
        self.k = k
        self.fmt = fmt
        self.wide = fmt == "mask16w"
        self.requant = fmt == "mask16q"
        self.mode = mode
        self.mode_int = {"train": codec.CROP_RANDOM, "center": codec.CROP_CENTER,
                         "full": codec.CROP_FULL}[mode]
        self.scale = scale
        # reference val: ResizedCenterCrop_DCT(size+4, size) (datasets.py:364)
        self.center_ratio = center_ratio or target / (target + 4)
        self.pack = build_op_pack(target, max_src)
        self.layout = packed_layout(target, k, fmt)
        self._offsets = codec.crop_row_offsets(self.layout)
        self._read_row = codec.read_crop_resize_pack_row

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        buf = np.zeros((self.batch_size, self.layout["row"]), np.uint8)
        labels = np.zeros((self.batch_size,), np.int32)
        weights = np.zeros((self.batch_size,), np.float32)
        # deterministic per-(seed, epoch, batch) crop randomness, drawn once
        # up front so the thread pool stays RNG-free
        rng = np.random.default_rng([self.seed, self.epoch, batch_index])
        uniforms = rng.random((self.batch_size, 12))
        ds_labels = self.dataset.labels
        ds_paths = self.dataset.paths

        def work(slot: int, ds_index: int):
            if ds_index < 0:  # shard-padding sentinel
                return
            label = int(ds_labels[ds_index])
            path = ds_paths[ds_index]
            # single GIL-free call writes every field (incl. label/weight)
            # straight into the consolidated row
            ncomp, yh, yw, ch, cw, *_box = self._read_row(
                path, self.k, self.mode_int, uniforms[slot], self.pack,
                buf[slot], self._offsets, label, 1.0,
                scale=self.scale, ratio=self.center_ratio, wide=self.wide,
                requant=self.requant,
            )
            _check_chroma_grid(path, ncomp, yh, yw, ch, cw)
            labels[slot] = label
            weights[slot] = 1.0

        list(pool.map(lambda args: work(*args), enumerate(idx)))
        return {"packed": buf, "labels": labels, "weights": weights}


class RgbCroppedLoader(_BaseLoader):
    """RGB crop-before-pack loader (the RGB ``"cropped"`` transfer): the host
    samples the reference's PIXEL-granular crop box (torchvision's
    RandomResizedCrop for ``mode="train"``, Resize + CenterCrop for the
    ViT's ``"center"`` eval, the whole image for SwinV2's ``"full"``;
    ``datasets.py:317-347``) and ships only the block-aligned window that
    covers it in a fixed ``size/8``-block mask16 row at ``k`` ACs a block,
    pre-downsampled per axis by the smallest f in {1, 2, 4} that fits, with
    the residual fractional box in ``geom``.  The device decodes the window
    and applies the box (``augment.pipeline.make_rgb_cropped_*_pipeline``).
    Per (seed, epoch, batch) the crop draws are 22 uniforms a row, drawn
    up front, so the rows are those of the JAX package's loader, byte for
    byte.

    Yields ``{"packed": uint8 (B, row), "labels": ..., "weights": ...}``.
    """

    def __init__(self, dataset: IndexDataset, batch_size: int, size: int = 224, k: int = 63,
                 mode: str = "train", scale: tuple[float, float] = (0.05, 1.0),
                 resize_to: float = 256.0, **kw):
        super().__init__(dataset, batch_size, **kw)
        from rgbnomore_tpu_torch import codec
        from rgbnomore_tpu_torch.data.croppack import rgb_downsample_blocks

        if mode not in ("train", "center", "full"):
            raise ValueError(f"unknown crop mode {mode!r}")
        if size % 16:
            raise ValueError(f"the window needs whole chroma blocks: size {size} is not a "
                             "multiple of 16")
        self.size, self.k, self.mode = size, k, mode
        self.mode_int = {"train": codec.RGB_CROP_TRAIN, "center": codec.RGB_CROP_CENTER,
                         "full": codec.RGB_CROP_FULL}[mode]
        self.scale, self.resize_to = scale, resize_to
        self.g2, self.g4 = rgb_downsample_blocks()
        self.layout = packed_layout(size // 8, k, "mask16", geom=True)
        self._offsets = codec.rgb_crop_row_offsets(self.layout)
        self._read_row = codec.read_rgb_crop_pack_row

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        buf = np.zeros((self.batch_size, self.layout["row"]), np.uint8)
        labels = np.zeros((self.batch_size,), np.int32)
        weights = np.zeros((self.batch_size,), np.float32)
        rng = np.random.default_rng([self.seed, self.epoch, batch_index])
        uniforms = rng.random((self.batch_size, 22))
        ds_labels, ds_paths = self.dataset.labels, self.dataset.paths

        def work(slot: int, ds_index: int):
            if ds_index < 0:  # shard-padding sentinel
                return
            label = int(ds_labels[ds_index])
            self._read_row(ds_paths[ds_index], self.k, self.size // 8, self.mode_int,
                           uniforms[slot], self.g2, self.g4, buf[slot], self._offsets, label,
                           1.0, scale=self.scale, resize_to=self.resize_to,
                           crop=float(self.size))
            labels[slot] = label
            weights[slot] = 1.0

        list(pool.map(lambda args: work(*args), enumerate(idx)))
        return {"packed": buf, "labels": labels, "weights": weights}


class RgbCanvasLoader(_BaseLoader):
    """Decoded RGB pixels on fixed uint8 canvases (the RGB ``"dense"``
    transfer): each image fully decoded by the codec (grayscale repeated to
    three channels) at the top left of an ``image_size`` square, zeros
    elsewhere; the crop and the augmentation run on the device.

    Yields ``{"pixels": (B, 3, S, S) uint8, "labels": (B,) int32, "weights":
    (B,) float32}``.
    """

    def __init__(self, dataset: IndexDataset, batch_size: int, image_size: int = 512, **kw):
        super().__init__(dataset, batch_size, **kw)
        from rgbnomore_tpu_torch import codec

        self.image_size = image_size
        self._read = codec.read_jpeg

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray,
                      batch_index: int = 0) -> dict:
        bsz, s = self.batch_size, self.image_size
        pixels = np.zeros((bsz, 3, s, s), np.uint8)
        labels = np.zeros((bsz,), np.int32)
        weights = np.zeros((bsz,), np.float32)

        def work(slot: int, ds_index: int):
            if ds_index < 0:  # shard-padding sentinel
                return
            img = self._read(self.dataset.paths[ds_index])
            ch, h, w = img.shape
            if ch == 1:
                img = np.broadcast_to(img, (3, h, w))
            hh, ww = min(h, s), min(w, s)
            pixels[slot, :, :hh, :ww] = img[:, :hh, :ww]
            labels[slot] = self.dataset.labels[ds_index]
            weights[slot] = 1.0

        list(pool.map(lambda args: work(*args), enumerate(idx)))
        return {"pixels": pixels, "labels": labels, "weights": weights}
