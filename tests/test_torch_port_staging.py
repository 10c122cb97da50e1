"""The port's dataset staging (``rgbnomore_tpu_torch/data/staging.py``)
on the CPU: the four staging tests of ``tests/test_data.py`` on the port's
copy, and the same synthetic ILSVRC-shaped tars staged by both packages,
resize included, to byte-identical trees and index CSVs.
"""

import numpy as np
import pytest
from PIL import Image

from torch_port_support import val_names, write_imagenet_tars
from rgbnomore_tpu.data import staging as jax_staging
from rgbnomore_tpu_torch import codec
from rgbnomore_tpu_torch.data import staging
from rgbnomore_tpu_torch.data.index import load_index

VAL_NAMES = val_names(2)  # the val images write_imagenet_tars writes by default
VAL_WNIDS = ["n01751748", "n09193705"]  # the vendored mapping's classes of VAL_NAMES


def test_staging_index_builder(tmp_path):
    rng = np.random.default_rng(0)
    for cls in ("n01", "n02"):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(2):
            arr = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            Image.fromarray(arr, "RGB").save(d / f"{cls}_{i}.JPEG")
    n = staging.build_index_csv(tmp_path, tmp_path / "idx.csv", "train")
    assert n == 4
    ds = load_index(tmp_path / "idx.csv")
    assert len(ds) == 4 and set(ds.labels.tolist()) == {0, 1}


def test_staging_png_masquerade(tmp_path):
    d = tmp_path / "train" / "n02105855"
    d.mkdir(parents=True)
    png_path = d / "n02105855_2933.JPEG"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8), "RGB").save(png_path, format="PNG")
    with pytest.raises(RuntimeError):
        codec.read_coefficients(str(png_path))
    assert staging.transcode_png_masquerade(tmp_path / "train")
    dims, quant, y, cbcr = codec.read_coefficients(str(png_path))  # now decodes
    assert y.shape == (1, 2, 2, 8, 8)


def test_staging_valprep_end_to_end(tmp_path):
    """Staging the synthetic tars gives a val tree split by class (the
    reference runs valprep.sh while staging, ``datasets.py:150-170``) and
    index CSVs for both splits."""
    mapping = staging.load_valprep_mapping()
    assert len(mapping) == 50000  # the full vendored valprep.sh data
    assert mapping[VAL_NAMES[0]] == VAL_WNIDS[0]

    src = write_imagenet_tars(tmp_path, np.random.default_rng(0))
    staged = tmp_path / "staged"
    staging.stage_dataset(src, staged, workers=2, no_resize=True)
    for name, wnid in zip(VAL_NAMES, VAL_WNIDS):
        assert (staged / "val" / wnid / name).exists()
        assert not (staged / "val" / name).exists()
    assert staging.build_index_csv(staged, tmp_path / "val_idx.csv", "val") == 2
    ds = load_index(tmp_path / "val_idx.csv")
    assert len(ds) == 2 and set(ds.labels.tolist()) == {0, 1}
    assert staging.build_index_csv(staged, tmp_path / "train_idx.csv", "train") == 4


def test_index_builder_rejects_flat_val(tmp_path):
    flat = tmp_path / "val"
    flat.mkdir()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8), "RGB").save(flat / VAL_NAMES[0])
    with pytest.raises(ValueError, match="valprep"):
        staging.build_index_csv(tmp_path, tmp_path / "idx.csv", "val")


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_both_packages_stage_the_same_bytes(tmp_path):
    """One set of tars (320x240 JPEGs) staged by the JAX package and by the
    port, resize included: the same files with the same bytes (512x512,
    4:2:0, classed val), and index CSVs that differ only in their root."""
    src = write_imagenet_tars(tmp_path, np.random.default_rng(1), size=(320, 240))
    trees = {}
    for name, mod in (("jax", jax_staging), ("port", staging)):
        root = tmp_path / name
        mod.stage_dataset(src, root, workers=2)
        for split in ("train", "val"):
            mod.build_index_csv(root, tmp_path / f"{name}_{split}.csv", split)
        trees[name] = _tree(root)
    assert trees["port"] == trees["jax"] and len(trees["port"]) == 6
    for name, wnid in zip(VAL_NAMES, VAL_WNIDS):
        assert f"val/{wnid}/{name}" in trees["port"]
    # 512x512 with 4:2:0 chroma: 64x64 luma blocks, 32x32 per chroma plane
    _, _, y, cbcr = codec.read_coefficients(
        str(tmp_path / "port" / "val" / VAL_WNIDS[0] / VAL_NAMES[0]))
    assert y.shape == (1, 64, 64, 8, 8) and cbcr.shape == (2, 32, 32, 8, 8)
    for split in ("train", "val"):
        port = (tmp_path / f"port_{split}.csv").read_text()
        jax = (tmp_path / f"jax_{split}.csv").read_text()
        assert port.replace(str(tmp_path / "port"), "ROOT") == \
            jax.replace(str(tmp_path / "jax"), "ROOT")
