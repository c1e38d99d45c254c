"""Datasets (counterpart of the JAX ``data_loading/dataset.py``): the identity
datasets of the feature extractor and the dataset helpers, copied exactly.

- ``check_dir``, ``check_images``, ``init_dataset`` and
  ``simple_init_dataset``: scans of a folder of pet-card folders;
- ``RecDataset``: the identity dataset over such a scan, its uid and index
  maps sorted by folder and file name (the anchor of ``PairGenerator``'s
  draws), ``label_map`` and ``start_class``; ``__getitem__`` returns
  ``{"x", "label", "index"}`` and reads ``.jpg``, ``.jpeg`` and ``.png`` as
  RGB with ``native.read_rgb`` (libjpeg or nvJPEG, and numpy PNG; no PIL)
  and ``.npy`` with numpy;
- ``RecSubset``: an index view with its own transform;
- ``ConcatDataset`` and the rot90 of xyxy boxes and (x, y) keypoints.

The pickled-table ``SimpleDataset`` (the dog fixtures) is not ported.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Callable

import numpy as np

from .. import native


def read_image(path: Path) -> np.ndarray:
    """``RecDataset``'s reader: ``.jpg``/``.jpeg``/``.png`` as RGB, ``.npy``
    as stored; ``ValueError`` for another suffix, ``OSError`` if it does not
    decode."""
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg", ".png"):
        return native.read_rgb(path)
    if suffix == ".npy":
        return np.load(path)
    raise ValueError(f"Unsupported file format: {path}")


def check_dir(path: Path, type_: int, min_number: int) -> bool:
    """A card folder with at least ``min_number`` images whose
    ``card.json['pet']['animal']`` is ``type_``."""
    path = Path(path)
    if not path.is_dir():
        return False
    card = path / "card.json"
    if not card.exists():
        return False
    try:
        info = json.loads(card.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return False
    n_images = len([p for p in path.iterdir() if p.name != "card.json"])
    return n_images >= min_number and int(info["pet"]["animal"]) == type_


def check_images(paths, preprocessor=None):
    """The images that decode (and pass ``preprocessor``); the others are
    dropped silently, as in the reference."""
    ok = []
    for path in paths:
        try:
            img = read_image(path)
            if preprocessor:
                preprocessor(img)
            ok.append(path)
        except Exception:
            pass
    return ok


def init_dataset(path, type_=1, min_number=3, preprocessor=None, paths_to_exclude=None):
    """A full scan with validation: card folders of ``type_``, less
    ``paths_to_exclude``, their decodable images, at least ``min_number``."""
    exclude = {Path(p).resolve() for p in (paths_to_exclude or ())}
    user_to_paths = {}
    for dir_ in Path(path).iterdir():
        if not check_dir(dir_, type_, min_number):
            continue
        img_paths = [p for p in dir_.iterdir()
                     if p.name != "card.json" and p.resolve() not in exclude]
        img_paths = check_images(img_paths, preprocessor)
        if len(img_paths) >= min_number:
            user_to_paths[dir_] = img_paths
    return user_to_paths


def simple_init_dataset(path, type_=1, min_number=3, *_, **__):
    """A scan without validation: every folder with ``min_number`` files."""
    user_to_paths = {}
    for dir_ in Path(path).iterdir():
        if not dir_.is_dir():
            continue
        img_paths = [p for p in dir_.iterdir() if p.name != "card.json"]
        if len(img_paths) >= min_number:
            user_to_paths[dir_] = img_paths
    return user_to_paths


class RecDataset:
    """Identity dataset over pet-card folders; ``dataset[i]`` is ``{"x": HWC
    image (after the preprocessor and augmentation), "label": int, "index":
    i}``, the label ``label_map[uid] + start_class``."""

    def __init__(self, path, type_: int = 1, min_number: int = 3,
                 preprocessor: Callable | None = None,
                 train_augmentation: Callable | None = None,
                 val_augmentation: Callable | None = None,
                 init_dataset_method: Callable = init_dataset,
                 paths_to_exclude=None, val_indices=None, start_class: int = 0):
        self.user_to_paths = init_dataset_method(path, type_, min_number, preprocessor,
                                                 paths_to_exclude)
        self.preprocessor = preprocessor
        self.start_class = start_class
        self.train_augmentation = train_augmentation
        self.val_augmentation = val_augmentation

        # the maps sorted by (folder name, file name), as the reference
        self.uid_to_user = dict(
            enumerate(sorted(set(self.user_to_paths), key=lambda x: str(x.name))))
        self.user_to_uid = {u: uid for uid, u in self.uid_to_user.items()}
        flat = [(u, p) for u in self.user_to_paths for p in self.user_to_paths[u]]
        flat.sort(key=lambda t: (str(t[0].name), str(t[1].name)))
        self.index_to_uid = {i: self.user_to_uid[u] for i, (u, _) in enumerate(flat)}
        self.index_to_path = {i: p for i, (_, p) in enumerate(flat)}
        uid_to_indices = defaultdict(list)
        for i, uid in self.index_to_uid.items():
            uid_to_indices[uid].append(i)
        self.uid_to_indices = dict(uid_to_indices)
        self.val_indices = val_indices
        self.label_map = dict(zip(self.uid_to_user.keys(), range(len(self.uid_to_user))))

    def __len__(self):
        return len(self.index_to_path)

    def __getitem__(self, item: int):
        if item < 0:
            item += len(self)
        img = read_image(self.index_to_path[item])
        label = self.label_map[self.index_to_uid[item]] + self.start_class
        if self.preprocessor:
            img = self.preprocessor(img)
        is_val = self.val_indices is not None and item in self.val_indices
        if not is_val and self.train_augmentation:
            img = self.train_augmentation(img)
        elif self.val_augmentation:
            img = self.val_augmentation(img)
        return {"x": img, "label": label, "index": item}

    def get_users(self):
        return list(self.user_to_uid.values())

    @property
    def val_indices(self):
        return self._val_indices

    @val_indices.setter
    def val_indices(self, value):
        self._val_indices = set(value) if value is not None else None


class RecSubset:
    """An index view of a dataset, ``transform`` applied to ``"x"``."""

    def __init__(self, dataset, indices, transform=None):
        self.dataset = dataset
        self.indices = list(indices)
        self.transform = transform

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item):
        data = self.dataset[self.indices[item]]
        if self.transform:
            data["x"] = self.transform(data["x"])
        return data


class ConcatDataset:
    """Concatenation of map-style datasets (torch ``ConcatDataset`` semantics)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, item):
        if item < 0:
            item += self._total
        for ds, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if item >= off:
                return ds[item - off]
        raise IndexError(item)


def rot90_boxes(boxes: np.ndarray, k: int, hw: tuple[int, int]) -> np.ndarray:
    """Rotate xyxy boxes by ``k`` * 90 degrees counter-clockwise (the
    ``np.rot90`` convention) in an image of size ``hw = (h, w)``."""
    h, w = hw
    out = boxes.copy().astype(float)
    for _ in range(k % 4):
        x1, y1, x2, y2 = out[..., 0], out[..., 1], out[..., 2], out[..., 3]
        # CCW 90: (x, y) -> (y, w - x); the new image is (w, h)
        out = np.stack([y1, w - x2, y2, w - x1], axis=-1)
        h, w = w, h
    return out


def rot90_keypoints(kps: np.ndarray, k: int, hw: tuple[int, int]) -> np.ndarray:
    """Rotate (x, y) keypoints by ``k`` * 90 degrees counter-clockwise."""
    h, w = hw
    out = kps.copy().astype(float)
    for _ in range(k % 4):
        x, y = out[..., 0], out[..., 1]
        out = np.stack([y, w - 1 - x], axis=-1)
        h, w = w, h
    return out
