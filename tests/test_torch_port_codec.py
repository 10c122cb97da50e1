"""The host codec built against the port's own libjpeg headers, linked two
ways, gives the same bytes and rows.

``native/build.py`` compiles ``dctcodec.cpp`` against the libjpeg-turbo
2.1.5 headers in ``native/include/`` and links the system's ``-ljpeg`` or,
where that does not link, the version-62 libjpeg that Pillow bundles.  Both
variants are built here into a temporary directory (never into ``_build/``),
each is loaded in a process of its own (two libjpegs in one process could
bind each other's symbols), and each writes six synthetic JPEGs with
``write_tensor`` and packs them into rows in the three crop modes: train at
K=16, center and full at K=48, target 32 blocks.  The JPEG files and the rows
must be byte-identical.  The test skips only where one of the two libraries
is missing.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from rgbnomore_tpu_torch.native import build

REPO = Path(__file__).resolve().parent.parent

_WRITE_AND_PACK = r"""
import sys
from pathlib import Path

import numpy as np

import rgbnomore_tpu_torch.native.build as native_build

ext, out = Path(sys.argv[1]), Path(sys.argv[2])
native_build.build = lambda force=False: ext  # load this variant, build nothing
from rgbnomore_tpu_torch import codec
from rgbnomore_tpu_torch.data.croppack import build_op_pack
from rgbnomore_tpu_torch.data.loader import packed_layout

rng = np.random.default_rng(0)
paths = []
for i, (h, w) in enumerate([(256, 256), (300, 200), (96, 160), (512, 384), (64, 64),
                            (333, 517)]):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.stack([(128 + 90 * np.sin(ys / (5 + i + c)) * np.cos(xs / (7 + c))
                     + 15 * rng.standard_normal((h, w))).clip(0, 255).astype(np.uint8)
                    for c in range(3)])
    paths.append(out / f"img{i}.jpg")
    codec.write_tensor(paths[-1], img, quality=90)
uniforms = np.random.default_rng(1).random((len(paths), 12))
pack = build_op_pack(32, 64)
for name, mode, k in (("train", codec.CROP_RANDOM, 16), ("center", codec.CROP_CENTER, 48),
                      ("full", codec.CROP_FULL, 48)):
    layout = packed_layout(32, k)
    offsets = codec.crop_row_offsets(layout)
    rows = np.zeros((len(paths), layout["row"]), np.uint8)
    for i, path in enumerate(paths):
        codec.read_crop_resize_pack_row(path, k, mode, uniforms[i], pack, rows[i], offsets, i,
                                        ratio=32 / 36)
    np.save(out / f"rows_{name}.npy", rows)
"""


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    links = {}
    for which in ("system", "pillow"):
        try:
            links[which] = build.jpeg_link_args(which)
        except RuntimeError as exc:
            pytest.skip(f"{which} libjpeg missing: {exc}")
    root = tmp_path_factory.mktemp("codec_variants")
    exts = {which: root / f"_dctcodec_{which}.so" for which in links}
    with ThreadPoolExecutor(2) as pool:  # the two g++ runs side by side
        list(pool.map(lambda w: build.compile_extension(exts[w], links[w]), links))
    outs = {}
    for which, ext in exts.items():
        outs[which] = root / which
        outs[which].mkdir()
        subprocess.run([sys.executable, "-c", _WRITE_AND_PACK, str(ext), str(outs[which])],
                       cwd=REPO, check=True, timeout=300)
    return links, outs


def test_variants_link_different_libraries(variants):
    links, _ = variants
    assert links["system"] == ["-ljpeg"]
    assert Path(links["pillow"][0]).name.startswith("libjpeg-")
    assert links["pillow"][1].startswith("-Wl,-rpath,")


def test_jpeg_bytes_identical(variants):
    _, outs = variants
    files = sorted(p.name for p in outs["system"].glob("*.jpg"))
    assert len(files) == 6
    for name in files:
        assert (outs["system"] / name).read_bytes() == (outs["pillow"] / name).read_bytes(), name


@pytest.mark.parametrize("mode", ["train", "center", "full"])
def test_rows_identical(variants, mode):
    _, outs = variants
    want = np.load(outs["system"] / f"rows_{mode}.npy")
    got = np.load(outs["pillow"] / f"rows_{mode}.npy")
    assert want.any()
    np.testing.assert_array_equal(got, want)


def _set_dqt_entry(jpeg: bytes, value: int, table: int = 0, zigzag: int = 1) -> bytes:
    """A copy of baseline JPEG bytes with entry ``zigzag`` of the 8-bit
    quant table ``table`` set to ``value``; the entropy-coded data, and so
    every stored coefficient, stay as they were."""
    buf = bytearray(jpeg)
    i = 2  # past SOI
    while buf[i + 1] != 0xDA:  # up to the first scan
        assert buf[i] == 0xFF
        length = int.from_bytes(buf[i + 2:i + 4], "big")
        j, end = i + 4, i + 2 + length
        while buf[i + 1] == 0xDB and j < end:
            precision, tq = buf[j] >> 4, buf[j] & 15
            if tq == table:
                assert precision == 0
                buf[j + 1 + zigzag] = value
                return bytes(buf)
            j += 1 + 64 * (precision + 1)
        i += 2 + length
    raise AssertionError(f"no quant table {table}")


@pytest.mark.parametrize("fmt", ["mask16q", "mask16"])
def test_zero_quant_entry_reads_as_one(tmp_path, fmt):
    """A JPEG whose luma DQT holds a 0 (position (0, 1)) packs as the same
    file with a 1 there: the codec reads a zero entry as 1, so the mask16q
    requantization never divides by 0, and the eval pipeline's output is
    finite."""
    import torch

    from rgbnomore_tpu_torch import codec
    from rgbnomore_tpu_torch.augment.pipeline import make_cropped_eval_pipeline
    from rgbnomore_tpu_torch.data.index import load_index
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader, row_views

    rng = np.random.default_rng(4)
    ys, xs = np.mgrid[0:96, 0:128]
    img = np.stack([(128 + 80 * np.sin(ys / (4 + c)) * np.cos(xs / 6)
                     + 20 * rng.standard_normal(ys.shape)).clip(0, 255).astype(np.uint8)
                    for c in range(3)])
    codec.write_tensor(tmp_path / "src.jpg", img, quality=90)
    src = (tmp_path / "src.jpg").read_bytes()
    for value in (0, 1):
        (tmp_path / f"q{value}.jpg").write_bytes(_set_dqt_entry(src, value))
    (tmp_path / "index.csv").write_text(
        f"Filepath,Label\n{tmp_path / 'q0.jpg'},3\n{tmp_path / 'q1.jpg'},3\n")
    ldr = DctCroppedLoader(load_index(tmp_path / "index.csv"), 2, target=8, k=48,
                           mode="center", fmt=fmt, num_threads=1)
    rows = next(iter(ldr))["packed"]
    assert (row_views(rows[0], ldr.layout)["quant"] >= 1).all()
    np.testing.assert_array_equal(rows[0], rows[1])
    y, c, _, _ = make_cropped_eval_pipeline(target=8, k=48, fmt=fmt)(torch.from_numpy(rows))
    assert torch.isfinite(y).all() and torch.isfinite(c).all()
