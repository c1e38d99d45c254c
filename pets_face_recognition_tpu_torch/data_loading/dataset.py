"""Dataset helpers (counterpart of the JAX ``data_loading/dataset.py``):
``ConcatDataset`` and the rot90 of xyxy boxes and (x, y) keypoints, copied
exactly. The identity datasets (``RecDataset``, ``RecSubset``) and the
pickled-table ``SimpleDataset`` come with feature-extractor training."""

from __future__ import annotations

import numpy as np


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
