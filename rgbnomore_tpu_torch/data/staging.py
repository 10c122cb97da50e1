"""Dataset staging (cold path): tar extraction, 512x512 resize, val-set
reorganisation, the PNG-masquerade transcode, msrsync passthrough and the
index CSV.

The port's copy of the JAX package's ``data/staging.py`` (which imports
nothing of JAX): capability parity with the reference staging stack
(``datasets.py:29-224``, ``utils/mp_scripts.py``,
``utils/pipeline_utils.py:200-258``, ``valprep.sh``) on
concurrent.futures, PIL and ``tarfile``.  It runs once per machine before
training (``python -m rgbnomore_tpu_torch.cli --stage_data``); the hot path
never touches it.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import tarfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = [
    "verify_tars",
    "load_valprep_mapping",
    "extract_imagenet_tars",
    "resize_images",
    "apply_valprep",
    "transcode_png_masquerade",
    "run_msrsync",
    "stage_dataset",
    "build_index_csv",
]

TRAIN_TAR = "ILSVRC2012_img_train.tar"
VAL_TAR = "ILSVRC2012_img_val.tar"
# The one ImageNet train file that is a PNG pretending to be a JPEG
# (``pipeline_utils.py:252-258``).
PNG_MASQUERADE = "n02105855_2933.JPEG"


def verify_tars(datapath: str | Path) -> None:
    """Check the expected ImageNet tars exist (``datasets.py:58-76``)."""
    datapath = Path(datapath)
    missing = [t for t in (TRAIN_TAR, VAL_TAR) if not (datapath / t).exists()]
    if missing:
        raise FileNotFoundError(f"Missing ImageNet tars in {datapath}: {missing}")


def extract_imagenet_tars(datapath: str | Path, out: str | Path, workers: int = 8) -> None:
    """Extract train tar (outer tar of per-class tars) and val tar.

    Reference: ``datasets.py:78-170`` (mp.Queue worker pools replaced by a
    thread pool; tarfile releases the GIL during IO).
    """
    datapath, out = Path(datapath), Path(out)
    train_dir = out / "train"
    val_dir = out / "val"
    train_dir.mkdir(parents=True, exist_ok=True)
    val_dir.mkdir(parents=True, exist_ok=True)

    log.info("Extracting %s", TRAIN_TAR)
    with tarfile.open(datapath / TRAIN_TAR) as outer:
        outer.extractall(train_dir, filter="data")

    class_tars = sorted(train_dir.glob("*.tar"))

    def extract_class(tar_path: Path):
        cls_dir = train_dir / tar_path.stem
        cls_dir.mkdir(exist_ok=True)
        with tarfile.open(tar_path) as t:
            t.extractall(cls_dir, filter="data")
        tar_path.unlink()

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(extract_class, class_tars))

    log.info("Extracting %s", VAL_TAR)
    with tarfile.open(datapath / VAL_TAR) as t:
        t.extractall(val_dir, filter="data")


def resize_images(root: str | Path, size: int = 512, workers: int = 8,
                  exts: tuple[str, ...] = (".JPEG", ".jpg", ".jpeg")) -> int:
    """Resize every image under ``root`` to ``size x size`` in place.

    Equivalent of the reference's ``ImageResizer`` pool
    (``utils/mp_scripts.py:10-113``); uses PIL bilinear like the original.
    Returns the number of images processed.
    """
    from PIL import Image

    paths = [p for p in Path(root).rglob("*") if p.suffix in exts]

    def work(p: Path):
        with Image.open(p) as img:
            img = img.convert("RGB").resize((size, size), Image.BILINEAR)
            # pin 4:2:0: the coefficient loaders require 2x2-subsampled chroma
            img.save(p, "JPEG", quality=95, subsampling="4:2:0")

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(work, paths))
    return len(paths)


def load_valprep_mapping() -> dict[str, str]:
    """The ImageNet val filename -> wnid mapping (50,000 entries).

    Vendored in ``assets/val_wnid_map.csv.gz`` — the same public data the
    reference ships as ``valprep.sh`` (one ``mv`` per image; originally from
    soumith/imagenet-multiGPU.torch, ``valprep.sh:1-2``).
    """
    import gzip

    asset = Path(__file__).resolve().parents[2] / "assets" / "val_wnid_map.csv.gz"
    mapping: dict[str, str] = {}
    with gzip.open(asset, "rt") as f:
        for line in f:
            fname, wnid = line.strip().split(",")
            mapping[fname] = wnid
    return mapping


def apply_valprep(val_dir: str | Path, mapping: dict[str, str] | None = None) -> int:
    """Move flat val images into per-class directories (valprep.sh semantics,
    run by the reference during staging, ``datasets.py:150-170``).

    ``mapping``: image filename -> wnid class directory name; defaults to the
    vendored ImageNet mapping (:func:`load_valprep_mapping`).  Returns the
    number of files moved (idempotent: already-moved files are skipped).
    """
    if mapping is None:
        mapping = load_valprep_mapping()
    val_dir = Path(val_dir)
    moved = 0
    for fname, wnid in mapping.items():
        src = val_dir / fname
        if not src.exists():
            continue
        dst_dir = val_dir / wnid
        dst_dir.mkdir(exist_ok=True)
        src.rename(dst_dir / fname)
        moved += 1
    return moved


def transcode_png_masquerade(train_dir: str | Path) -> bool:
    """Re-encode the known PNG-in-disguise train file as real JPEG.

    Reference: ``datasets.py:207-223``.  Returns True if found and fixed.
    """
    from PIL import Image

    hits = list(Path(train_dir).rglob(PNG_MASQUERADE))
    for p in hits:
        with Image.open(p) as img:
            img.convert("RGB").save(p, "JPEG", quality=100, subsampling="4:2:0")
    return bool(hits)


def run_msrsync(src: str | Path, dst: str | Path, processes: int = 8) -> None:
    """Parallel-rsync a pre-extracted tree (``datasets.py:177-205``).

    Falls back to ``shutil.copytree`` when msrsync is not installed.
    """
    if shutil.which("msrsync"):
        subprocess.run(
            ["msrsync", "-p", str(processes), str(src), str(dst)], check=True
        )
    else:
        log.warning("msrsync not found; falling back to shutil.copytree")
        shutil.copytree(src, dst, dirs_exist_ok=True)


def stage_dataset(
    datapath: str | Path,
    temp_datapath: str | Path,
    *,
    no_extract: bool = False,
    no_resize: bool = False,
    use_msrsync: bool = False,
    workers: int = 8,
) -> None:
    """Full staging flow (reference: ``copy_dataset``, ``pipeline_utils.py:200-258``)."""
    temp = Path(temp_datapath)
    if no_extract and temp.exists():
        log.info("Skipping extraction; using %s", temp)
    elif use_msrsync:
        run_msrsync(datapath, temp, processes=workers)
    else:
        verify_tars(datapath)
        extract_imagenet_tars(datapath, temp, workers=workers)
    transcode_png_masquerade(temp / "train")
    if (temp / "val").exists():
        moved = apply_valprep(temp / "val")
        if moved:
            log.info("valprep: moved %d val images into wnid directories", moved)
    if not no_resize:
        n = resize_images(temp, size=512, workers=workers)
        log.info("Resized %d images to 512x512", n)


def build_index_csv(root: str | Path, out_csv: str | Path, split: str = "train") -> int:
    """Write a ``Filepath,Label`` CSV for a class-directory tree.

    Classes are the sorted wnid directory names (torchvision ImageFolder
    convention, matching the reference's index CSVs in ``assets/``).
    """
    root = Path(root) / split
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise ValueError(
            f"{root} has no class directories — for a flat val tree run "
            "apply_valprep (stage_dataset does this automatically) before "
            "indexing"
        )
    rows = []
    for label, cls in enumerate(classes):
        for p in sorted((root / cls).iterdir()):
            rows.append((str(p), label))
    with open(out_csv, "w") as f:
        f.write("Filepath,Label\n")
        for p, l in rows:
            f.write(f"{p},{l}\n")
    return len(rows)
