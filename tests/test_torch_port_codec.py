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
