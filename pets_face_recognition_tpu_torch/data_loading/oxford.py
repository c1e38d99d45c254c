"""Oxford-IIIT Pet with head boxes, trimap masks and body boxes (counterpart
of the JAX ``data_loading/oxford.py``).

- head boxes from ``annotations/xmls`` with the ``dog``/``cat`` name tag;
- the body box from the trimap's extents: a trimap sample other than 2 is
  foreground, and the box runs from the first to one past the last column
  and row that hold one; an image whose trimap has none is dropped;
- target types ``category``, ``bbox``, ``segmentation``, ``body_bbox`` and
  ``big_class``;
- ``OxfordSubset``: a train or validation view that emits per-image
  ``{"boxes", "labels"[, "masks"]}`` numpy targets for the padded collate;
  box-only targets can be turned by a random angle (``rotate``) or a random
  multiple of 90 degrees (``rotate90``), the ``("body_bbox",
  "segmentation")`` targets by ``rotate90`` only: that route never reads
  ``rotate``, so the Mask R-CNN recipe, which passes ``rotate=True``, trains
  unturned, as in JAX.

Photos decode through the port's ``native`` routes (``read_rgb``), never
PIL. Trimaps are read as their stored samples (``native.png.read_png_samples``),
as ``np.array(PIL.Image.open(path))`` gives them: the values of a grey PNG,
the indices of a palette one.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Sequence

import numpy as np

from .. import native
from ..native import png
from .dataset import rot90_boxes
from .transforms import rotate_bbox, rotate_image

_VALID_TARGET_TYPES = ("category", "bbox", "segmentation", "body_bbox", "big_class")


class OxfordIIITPet:
    def __init__(self, root: str | Path, split: Sequence[str] | None = None,
                 target_types: Sequence[str] | str = "category"):
        self._split = tuple(split) if split is not None else ("trainval", "test")
        if isinstance(target_types, str):
            target_types = [target_types]
        for t in target_types:
            assert t in _VALID_TARGET_TYPES, t
        self.target_types = list(target_types)

        base = Path(root)
        # the dataset root or its parent, which nests "oxford-iiit-pet"
        if (base / "oxford-iiit-pet").exists():
            base = base / "oxford-iiit-pet"
        self._images_folder = base / "images"
        self._anns_folder = base / "annotations"
        self._bbox_folder = self._anns_folder / "xmls"
        self._segs_folder = self._anns_folder / "trimaps"
        if not self._images_folder.is_dir() or not self._anns_folder.is_dir():
            raise RuntimeError(f"Oxford-IIIT Pet not found under {base}")

        with_xml = {p.name[:-4] for p in self._bbox_folder.iterdir()}
        image_ids, self._labels = [], []
        for split_name in self._split:
            for line in (self._anns_folder / f"{split_name}.txt").read_text().splitlines():
                image_id, label, *_ = line.strip().split()
                if image_id in with_xml:
                    image_ids.append(image_id)
                    self._labels.append(int(label) - 1)

        self.classes = [
            " ".join(part.title() for part in raw.split("_"))
            for raw, _ in sorted({(i.rsplit("_", 1)[0], lab)
                                  for i, lab in zip(image_ids, self._labels)},
                                 key=lambda t: t[1])
        ]
        self.class_to_idx = dict(zip(self.classes, range(len(self.classes))))

        self._images = [self._images_folder / f"{i}.jpg" for i in image_ids]
        parsed = [self._parse_xml(self._bbox_folder / f"{i}.xml") for i in image_ids]
        self._bbox = [p[0] for p in parsed]
        self.big_classes = [p[1] for p in parsed]
        self._segs = [self._segs_folder / f"{i}.png" for i in image_ids]
        self._body_bbox = None

        if "body_bbox" in self.target_types:
            keep, body = [], {}
            for i, seg in enumerate(self._segs):
                m = (png.read_png_samples(seg) != 2).astype(int)
                if m.sum() == 0:
                    continue
                cols = (m.sum(axis=0) == 0).tolist()
                x1, x2 = cols.index(False), len(cols) - cols[::-1].index(False)
                rows = (m.sum(axis=1) == 0).tolist()
                y1, y2 = rows.index(False), len(rows) - rows[::-1].index(False)
                assert x1 < x2 and y1 < y2
                body[len(keep)] = (x1, y1, x2, y2)
                keep.append(i)
            self._body_bbox = body
            for attr in ("_segs", "_bbox", "big_classes", "_images", "_labels"):
                setattr(self, attr, [getattr(self, attr)[j] for j in keep])

    def __len__(self):
        return len(self._images)

    def __getitem__(self, idx: int):
        image = native.read_rgb(self._images[idx])
        target = []
        for t in self.target_types:
            if t == "category":
                target.append(self._labels[idx])
            elif t == "big_class":
                target.append(self.big_classes[idx])
            elif t == "bbox":
                target.append([np.array(self._bbox[idx], np.int64)])
            elif t == "body_bbox":
                target.append([np.array(self._body_bbox[idx], np.int64)])
            else:  # segmentation
                target.append((png.read_png_samples(self._segs[idx]) != 2).astype(int))
        return image, (tuple(target) if target else None)

    @staticmethod
    def _parse_xml(path: Path):
        d = dict.fromkeys(("xmin", "ymin", "xmax", "ymax", "name"))
        for _, elem in ET.iterparse(str(path)):
            if elem.tag in d:
                d[elem.tag] = elem.text
        assert all(v is not None for v in d.values())
        vals = tuple(d.values())
        return [int(v) for v in vals[:-1]], ["dog", "cat"].index(vals[-1])


class OxfordSubset:
    """``indices`` of ``dataset`` as padded-collate samples; see the module
    docstring. The turns are drawn from one ``RandomState(seed)`` that every
    loader thread shares, as in JAX."""

    def __init__(self, dataset: OxfordIIITPet, indices: Sequence[int],
                 rotate: float | bool = False, rotate90: bool = False,
                 big_classes: bool = False, seed: int | None = None):
        assert not (rotate and rotate90)
        self.dataset = dataset
        self.indices = list(indices)
        self.rotate = 15.0 if rotate is True else float(rotate or 0.0)
        self.rotate90 = rotate90
        self.big_classes = big_classes
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        image, target_list = self.dataset[self.indices[idx]]
        tt = list(self.dataset.target_types)
        h, w = image.shape[:2]

        if all(t in ("bbox", "body_bbox") for t in tt):
            boxes = [np.asarray(b, float) for grp in target_list for b in grp]
            if self.rotate:
                angle = float(self.rng.uniform(-self.rotate, self.rotate))
                image = rotate_image(image, angle)
                boxes = [np.round(rotate_bbox(b, angle, (h, w))) for b in boxes]
            elif self.rotate90:
                k = int(self.rng.randint(0, 4))
                if k:
                    image = np.ascontiguousarray(np.rot90(image, k))
                    boxes = [np.round(rot90_boxes(b, k, (h, w))) for b in boxes]
            big = self.dataset.big_classes[self.indices[idx]]
            if self.big_classes:
                if len(tt) == 1:
                    labels = [big] * len(target_list[0])
                else:
                    labels = [0] * len(target_list[0]) + [big + 1] * len(target_list[1])
            else:
                labels = [0] * len(target_list[0])
                if len(target_list) == 2:
                    labels += [1] * len(target_list[1])
            return image, {"boxes": np.stack(boxes).astype(np.float32),
                           "labels": np.asarray(labels, np.int32)}

        assert set(tt) == {"body_bbox", "segmentation"}, tt
        seg = np.asarray(target_list[tt.index("segmentation")])
        boxes = [np.asarray(b, float) for b in target_list[tt.index("body_bbox")]]
        if self.rotate90:
            k = int(self.rng.randint(0, 4))
            if k:
                image = np.ascontiguousarray(np.rot90(image, k))
                seg = np.ascontiguousarray(np.rot90(seg, k))
                boxes = [np.round(rot90_boxes(b, k, (h, w))) for b in boxes]
        label = self.dataset.big_classes[self.indices[idx]] + 1 if self.big_classes else 0
        return image, {"boxes": np.stack(boxes).astype(np.float32),
                       "labels": np.asarray([label], np.int32),
                       "masks": seg[None].astype(np.float32)}
