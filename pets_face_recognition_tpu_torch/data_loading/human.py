"""Human-face sanity datasets (counterpart of the JAX ``data_loading/human.py``),
the verification baseline on LFW. Unused by the production configs, kept for
parity with JAX.

- ``init_dataset_ms1m``: the no-filter scan of a folder of identity folders,
  usable as a ``RecDataset`` init method;
- ``LFWDataset``: the deep-funneled LFW tree keyed by ``people.csv``, items
  ``{"x", "label", "index"}``. ``people.csv`` is read with ``csv`` (no
  pandas): a ``name`` that pandas would read as missing (empty, ``NA``,
  ``nan`` ...) is skipped, as the JAX reader drops its NaNs. Photos decode
  with the port's native routes (a gray JPEG stays 2-D, as PIL gives it).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from .dataset import read_photo

# pandas.read_csv's default missing-value strings
_PANDAS_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                        "nan", "null"})


def init_dataset_ms1m(path, *_, **__):
    """``{identity folder: [its files]}`` over every folder in ``path``."""
    user_to_paths = {}
    for dir_ in Path(path).iterdir():
        if dir_.is_dir():
            user_to_paths[dir_] = list(dir_.iterdir())
    return user_to_paths


def _people(csv_path: Path) -> list[str]:
    with open(csv_path, newline="") as f:
        return [row["name"] for row in csv.DictReader(f)
                if row.get("name") is not None and row["name"] not in _PANDAS_NA]


class LFWDataset:
    """Every photo of every person named in ``root/people.csv`` under
    ``root/lfw-deepfunneled/lfw-deepfunneled/<name>/<name>_<n>.jpg``, indexed
    in the csv's order and each folder's listing order; ``label`` is the rank
    of the name among all names, ``x`` the photo as float32 in ``[0, 1]``;
    ``uid_to_indices`` lets a ``PairGenerator`` sample over identities."""

    def __init__(self, root: str | Path = "lfw"):
        root = Path(root)
        self.p = root / "lfw-deepfunneled" / "lfw-deepfunneled"
        self.keys: dict[int, tuple[str, int]] = {}
        self.dataset: dict[tuple[str, int], Path] = {}
        c = 0
        for dir_ in _people(root / "people.csv"):
            files = tuple((self.p / dir_).iterdir())
            keys = [f.name[:-4].split("_") for f in files]
            keys = [("_".join(k[:-1]), int(k[-1])) for k in keys]
            for key, f in zip(keys, files):
                self.dataset[key] = f
                self.keys[c] = key
                c += 1
        self.inverted_keys = {v: k for k, v in self.keys.items()}
        self.labels = {name: i for i, name in enumerate(sorted({k[0] for k in self.dataset}))}
        self.uid_to_indices: dict[int, list[int]] = {}
        for idx, (name, _) in self.keys.items():
            self.uid_to_indices.setdefault(self.labels[name], []).append(idx)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item: int):
        name, id_ = self.keys[item]
        img = read_photo(self.dataset[name, id_])
        return {"x": np.asarray(img, np.float32) / 255.0, "label": self.labels[name],
                "index": item}

    def get_users(self):
        return list(self.labels.values())
