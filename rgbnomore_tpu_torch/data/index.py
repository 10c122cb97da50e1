"""CSV-index datasets and split logic.

The reference reads ``Filepath,Label`` CSVs (``datasets.py:226-303``) and
splits train into train / 1% minival with a fixed seed, plus a 5%-of-train
"trainval" eval subset (``datasets.py:513-520``).  Splits here use a
dedicated numpy RNG seeded identically on every host so all processes agree.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["IndexDataset", "load_index", "split_train_minival"]


@dataclasses.dataclass
class IndexDataset:
    paths: np.ndarray  # object array of str
    labels: np.ndarray  # int32

    def __len__(self) -> int:
        return len(self.paths)

    def subset(self, indices) -> "IndexDataset":
        idx = np.asarray(indices)
        return IndexDataset(self.paths[idx], self.labels[idx])


def load_index(csv_path: str | Path, root: str | Path | None = None) -> IndexDataset:
    """Load a ``Filepath,Label`` CSV; ``root`` is prepended to relative paths."""
    paths: list[str] = []
    labels: list[int] = []
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        assert header[0].lower().startswith("filepath"), f"Unexpected index header: {header}"
        for row in reader:
            if not row:
                continue
            p = row[0]
            if root is not None and not p.startswith("/"):
                p = str(Path(root) / p)
            paths.append(p)
            labels.append(int(row[1]))
    return IndexDataset(np.asarray(paths, dtype=object), np.asarray(labels, dtype=np.int32))


def split_train_minival(
    ds: IndexDataset, split: float = 0.01, trainval_frac: float = 0.05, seed: int = 11997733
):
    """Seeded split into (train, minival, trainval).

    minival = ``split`` fraction held out of train; trainval = a fixed
    ``trainval_frac`` sample *of the remaining train* for train-set eval
    (``datasets.py:513-520``).
    """
    n = len(ds)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(round(n * split))
    minival_idx = perm[:n_val]
    train_idx = perm[n_val:]
    n_tv = int(round(len(train_idx) * trainval_frac))
    trainval_idx = rng.permutation(train_idx)[:n_tv]
    return ds.subset(train_idx), ds.subset(minival_idx), ds.subset(trainval_idx)
