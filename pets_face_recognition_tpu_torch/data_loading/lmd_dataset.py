"""CAT_DATASET landmark dataset (counterpart of the JAX
``data_loading/lmd_dataset.py``): ``*.jpg`` photos with ``*.jpg.cat`` files
of 9 landmarks, of which the first 3 (left eye, right eye, nose) are kept.

The head box is synthesised from them exactly as in JAX: the eye centre
+- 1.4 x the eye distance horizontally and +- 1.8 x the eye-centre-to-nose
distance vertically, clamped to the image, and widened to hold every landmark
+- 1 px. ``CatLMDSubset`` draws a random turn of the image, box and keypoints from
its own seeded ``RandomState``: by an angle (``rotate``, cv2's rotation in
numpy, ``transforms``) or by a multiple of 90 degrees (``rotate90``).

Photos decode with the port's ``native/`` route (libjpeg, or nvJPEG on hosts
with the CUDA toolkit only), never PIL; a grayscale JPEG comes back 2-D, as
``np.array(PIL.Image.open(path))`` gives it. ``LMDDataset`` (CelebA
mixing) is not ported (ROADMAP §1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from .. import native
from .dataset import rot90_boxes, rot90_keypoints
from .transforms import rotate_bbox, rotate_image, rotate_points


def read_jpeg(path: str | Path) -> np.ndarray:
    """``(H, W, 3)`` uint8, or ``(H, W)`` for a one-component JPEG; raises
    ``OSError`` when the file does not decode."""
    image = native.decode_single(path)
    if image is None:
        raise OSError(f"cannot decode {path}")
    # both native routes copy a gray image's Y plane to the three channels
    return image[..., 0].copy() if native.jpeg_components(path) == 1 else image


class CatLMDDataset:
    def __init__(self, path: str | Path):
        path = Path(path)
        self.paths = [fp for d in sorted(path.iterdir()) if d.is_dir()
                      for fp in sorted(d.glob("*.jpg"))]
        self.lmd = [self.read_lmd(p) for p in self.paths]

    @staticmethod
    def read_lmd(path: Path):
        text = Path(str(path.resolve()) + ".cat").read_text()
        return list(map(int, text.split()))[1:]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, item: int):
        image = read_jpeg(self.paths[item])
        raw = self.lmd[item]
        lmd = np.array([(raw[i], raw[i + 1], 1) for i in range(0, len(raw), 2)],
                       float)
        center = (lmd[0, :2] + lmd[1, :2]) / 2
        dif_eyes = np.sqrt(((lmd[0, :2] - lmd[1, :2]) ** 2).sum())
        dif_nose = np.sqrt(((center - lmd[2, :2]) ** 2).sum())
        bbox = [
            max(0, min(center[0] - dif_eyes * 1.4, *(lmd[:, 0] - 1))),
            max(0, min(center[1] - dif_nose * 1.8, *(lmd[:, 1] - 1))),
            min(image.shape[1] - 1, max(center[0] + dif_eyes * 1.4,
                                        *(lmd[:, 0] + 1))),
            min(image.shape[0] - 1, max(center[1] + dif_nose * 1.8,
                                        *(lmd[:, 1] + 1))),
        ]
        return image, {
            "boxes": np.round(np.asarray(bbox, float))[None],
            "keypoints": lmd[:3][None],  # (1, 3, 3)
            "labels": np.asarray([0], np.int32),
        }


class CatLMDSubset:
    """``indices`` of ``dataset``; with ``rotate`` (degrees, ``True`` for 15)
    each item is turned by an angle drawn uniformly from ``[-rotate,
    rotate)``, a keypoint turned off the image marked invisible; with
    ``rotate90`` by a random multiple of 90 degrees; both drawn from
    ``RandomState(seed)``. The state
    is shared by every thread that reads the subset, so under a threaded
    loader the draws follow the threads' order, in JAX as here (ROADMAP §3)."""

    def __init__(self, dataset, indices: Sequence[int], rotate: float | bool = False,
                 rotate90: bool = False, seed: int | None = None):
        assert not (rotate and rotate90)
        self.dataset = dataset
        self.indices = list(indices)
        self.rotate = 15.0 if rotate is True else float(rotate or 0.0)
        self.rotate90 = rotate90
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        image, t = self.dataset[self.indices[idx]]
        h, w = image.shape[:2]
        boxes = t["boxes"].astype(float)
        kps = t["keypoints"].astype(float)
        if self.rotate:
            angle = float(self.rng.uniform(-self.rotate, self.rotate))
            image = rotate_image(image, angle)
            boxes = np.stack([np.round(rotate_bbox(b, angle, (h, w))) for b in boxes])
            for i in range(len(kps)):
                kps[i, :, :2] = rotate_points(kps[i, :, :2], angle, (h, w))
            inside = ((kps[..., 0] >= 0) & (kps[..., 0] <= w)
                      & (kps[..., 1] >= 0) & (kps[..., 1] <= h))
            kps[..., 2] = inside.astype(float)
        elif self.rotate90:
            k = int(self.rng.randint(0, 4))
            if k:
                image = np.ascontiguousarray(np.rot90(image, k))
                boxes = np.round(rot90_boxes(boxes, k, (h, w)))
                kps[..., :2] = rot90_keypoints(kps[..., :2], k, (h, w))
        return image, {
            "boxes": boxes.astype(np.float32),
            "keypoints": kps.astype(np.float32),
            "labels": t["labels"],
        }
