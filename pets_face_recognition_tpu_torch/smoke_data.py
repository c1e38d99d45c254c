"""Seeded synthetic corpora in the reference layouts, for the feature
extractor's training, for the aligned-corpus transform, for Mask R-CNN's
training and for the retrieval quality instrument (counterpart of
``tools/make_smoke_datasets.py``'s ``make_fe``, ``make_data25``,
``make_petfinder_extras``, ``make_oxford`` and ``make_kashtanka_hard``).

Each writer makes the same arrays from the same ``RandomState`` call sequence
as the tool, and encodes them with the port's own encoders (``native``: JPEG
at the tool's quality 92; :mod:`.native.png`), since the card's machine runs
no PIL for the port. On a host whose JPEG route is libjpeg the files are
byte-identical to the tool's; through nvJPEG the JPEGs differ by its
encoder's rounding.

- ``make_fe``: ``smoke_fe_cats/card_XXX/img_J.jpg``, ``n_ids`` identities of
  ``n_imgs`` textured crops, an identity colour each;
- ``make_data25``: ``data_25/<card>/{card.json, *.jpg}`` (kashtanka layout,
  animal 1 or 2 by turns) with two of ``DATA_25_EXCLUDE``'s names;
- ``make_petfinder_extras``: ``petfinder_extra_{dogs,cats}/<id>/<j>.png``
  with the entries the transform excludes;
- ``make_oxford``: the Oxford-IIIT Pet layout (photos, 8-bit grey trimaps,
  head-box XML, split files);
- ``make_kashtanka_hard``: a kashtanka test split of near-duplicate
  identities and its ground truth, for ``quality_instrument``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .native import png, write_jpeg


def _texture(rng: np.random.RandomState, base: np.ndarray, size: int) -> np.ndarray:
    """Identity-coloured noisy texture with two "eyes" and a "nose"."""
    img = np.clip(base[None, None, :] + rng.normal(0, 25, (size, size, 3)), 0,
                  255).astype(np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for cx, cy, r, col in ((size // 3, size // 3, size // 12, 0),
                           (2 * size // 3, size // 3, size // 12, 0),
                           (size // 2, 2 * size // 3, size // 10, 255)):
        m = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
        img[m] = col
    return img


def make_fe(root: Path, n_ids: int = 16, n_imgs: int = 6, size: int = 224,
            seed: int = 0) -> Path:
    rng = np.random.RandomState(seed)
    out = Path(root) / "smoke_fe_cats"
    for i in range(n_ids):
        d = out / f"card_{i:03d}"
        d.mkdir(parents=True, exist_ok=True)
        base = rng.uniform(40, 215, 3)
        for j in range(n_imgs):
            write_jpeg(d / f"img_{j}.jpg", _texture(rng, base, size), quality=92)
    return out


def pet_image(rng: np.random.RandomState, size: int = 320,
              base: np.ndarray | None = None) -> np.ndarray:
    """A pet-like photo with the eyes and nose of the CAT miniature's
    construction; ``base`` tints its background."""
    if base is not None:
        img = np.clip(base[None, None, :] + rng.normal(0, 20, (size, size, 3)), 0,
                      255).astype(np.uint8)
    else:
        img = rng.randint(30, 120, (size, size, 3), np.uint8)
    cx, cy = rng.randint(size // 3, 2 * size // 3, 2)
    d = rng.randint(30, 60)
    pts = [(cx - d, cy), (cx + d, cy), (cx, cy + int(1.2 * d))]
    yy, xx = np.mgrid[:size, :size]
    for (x, y), col in zip(pts, ((255, 255, 255), (255, 255, 255), (255, 128, 128))):
        m = (xx - x) ** 2 + (yy - y) ** 2 < 36
        img[m] = col
    return img


def make_data25(root: Path, n_cards: int = 6, n_imgs: int = 3, seed: int = 3) -> Path:
    rng = np.random.RandomState(seed)
    out = Path(root) / "data_25"
    for i in range(n_cards):
        card = out / (f"rl{131336 + i}" if i % 2 == 0 else f"rf{337006 + i}")
        card.mkdir(parents=True, exist_ok=True)
        (card / "card.json").write_text('{"pet": {"animal": %d}}' % (1 + i % 2))
        for j in range(n_imgs):
            write_jpeg(card / f"{600000 + 10 * i + j}.jpg", pet_image(rng), quality=92)
    # two names of the transform's exclusion list
    for rel in ("rl131336/216319.jpg", "rl378360/660074.jpg"):
        p = out / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if not (p.parent / "card.json").exists():
            (p.parent / "card.json").write_text('{"pet": {"animal": 1}}')
        write_jpeg(p, pet_image(rng), quality=92)
    return out


def make_petfinder_extras(root: Path, n_cards: int = 3, n_imgs: int = 2,
                          seed: int = 4) -> tuple[Path, Path]:
    rng = np.random.RandomState(seed)
    dogs = Path(root) / "petfinder_extra_dogs"
    cats = Path(root) / "petfinder_extra_cats"
    for base, first in ((dogs, 48009947), (cats, 24355557)):
        for i in range(n_cards):
            d = base / str(first + i)
            d.mkdir(parents=True, exist_ok=True)
            for j in range(n_imgs):
                png.write_png(d / f"{j}.png", pet_image(rng))
    # the excluded entries exist (the transform lists them unconditionally)
    for d in (dogs / "48683845", dogs / "45528036"):
        d.mkdir(parents=True, exist_ok=True)
        png.write_png(d / "0.png", pet_image(rng))
    png.write_png(dogs / "48009947" / "3.png", pet_image(rng))
    png.write_png(cats / "24355557" / "4.png", pet_image(rng))
    return dogs, cats


_OXFORD_XML = """<annotation><object><name>{name}</name><bndbox>
<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>
</bndbox></object></annotation>"""


def make_oxford(root: Path, n_imgs: int = 40, size: int = 320, seed: int = 2) -> Path:
    """``oxford-iiit-pet/`` under ``root``: ``n_imgs`` photos of a dark blob
    on a light ground, cats and dogs by turns, each with its trimap (1 on the
    blob, 2 elsewhere, 8-bit grey PNG), a head box over the blob's upper
    half in ``annotations/xmls`` and a line in ``trainval.txt`` (four in
    five) or ``test.txt``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "oxford-iiit-pet"
    for d in ("images", "annotations/xmls", "annotations/trimaps"):
        (base / d).mkdir(parents=True, exist_ok=True)
    lines = {"trainval": [], "test": []}
    for i in range(n_imgs):
        species = "cat" if i % 2 == 0 else "dog"
        stem = f"{'Abyssinian' if species == 'cat' else 'beagle'}_{i + 1}"
        img = rng.randint(140, 200, (size, size, 3), np.uint8)
        cx, cy = rng.randint(size // 3, 2 * size // 3, 2)
        ax, ay = rng.randint(40, 80, 2)
        yy, xx = np.mgrid[:size, :size]
        blob = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 < 1.0
        img[blob] = rng.randint(0, 100, 3, np.uint8)
        write_jpeg(base / "images" / f"{stem}.jpg", img, quality=92)
        tri = np.full((size, size), 2, np.uint8)
        tri[blob] = 1
        png.write_png(base / "annotations" / "trimaps" / f"{stem}.png", tri)
        x1, x2 = max(0, cx - ax // 2), min(size - 1, cx + ax // 2)
        y1, y2 = max(0, cy - ay), cy
        (base / "annotations" / "xmls" / f"{stem}.xml").write_text(
            _OXFORD_XML.format(name=species, x1=x1, y1=y1, x2=x2, y2=y2))
        label = 1 if species == "cat" else 2
        lines["trainval" if i % 5 else "test"].append(f"{stem} {label} 1 1")
    for split, ls in lines.items():
        (base / "annotations" / f"{split}.txt").write_text("\n".join(ls) + "\n")
    return base


def make_kashtanka_hard(root: Path, n_ids: int = 120, n_clusters: int = 12,
                        n_distractors: int = 180, n_imgs: int = 3, seed: int = 9) -> Path:
    """``test_hard/`` under ``root`` and ``root/hard_gt.json``: a retrieval
    split where ranking is hard. Each identity's tint is drawn near one of
    ``n_clusters`` cluster centres (so every identity has near-duplicate
    confusers), and its eye distance is a second trait; each image adds a
    lighting shift, noise and its own face position and eye-distance jitter.
    Queries are the ``lost/lost`` cards ``rl{900000 + i}``; the gallery
    ``lost/extra_lost`` holds each query's true match ``rf{950000 + i}``
    (the same identity, fresh images) and ``n_distractors`` cards from the
    same clusters; ``hard_gt.json`` maps query to match. Two cards on each
    ``found`` side keep the walk's layout. ``n_imgs`` 320 x 320 JPEGs a
    card."""
    rng = np.random.RandomState(seed)
    out = Path(root) / "test_hard"
    centers = rng.uniform(45, 105, (n_clusters, 3))

    def identity():
        c = centers[rng.randint(n_clusters)]
        tint = np.clip(c + rng.normal(0, 5, 3), 35, 115)
        return tint, rng.randint(32, 56)

    def image(tint, d_eye, size=320):
        img = np.clip(tint[None, None, :] + rng.normal(0, 8, 3)[None, None, :]
                      + rng.normal(0, 12, (size, size, 3)), 0, 255).astype(np.uint8)
        cx, cy = rng.randint(size // 3, 2 * size // 3, 2)
        d = max(20, d_eye + rng.randint(-3, 4))
        pts = [(cx - d, cy), (cx + d, cy), (cx, cy + int(1.2 * d))]
        yy, xx = np.mgrid[:size, :size]
        for (x, y), col in zip(pts, ((255, 255, 255), (255, 255, 255), (255, 128, 128))):
            img[(xx - x) ** 2 + (yy - y) ** 2 < 36] = col
        return img

    def card(d: Path, animal: int, tint, d_eye):
        d.mkdir(parents=True, exist_ok=True)
        (d / "card.json").write_text('{"animal": %d}' % animal)
        for j in range(n_imgs):
            write_jpeg(d / f"{j}.jpg", image(tint, d_eye), quality=92)

    gt = {}
    for i in range(n_ids):
        tint, d_eye = identity()
        q, m = f"rl{900000 + i}", f"rf{950000 + i}"
        card(out / "lost" / "lost" / q, 1 + i % 2, tint, d_eye)
        card(out / "lost" / "extra_lost" / m, 1 + i % 2, tint, d_eye)
        gt[q] = m
    for i in range(n_distractors):
        tint, d_eye = identity()
        card(out / "lost" / "extra_lost" / f"rf{960000 + i}", 1 + i % 2, tint, d_eye)
    for i in range(2):
        tint, d_eye = identity()
        card(out / "found" / "found" / f"rf{990000 + i}", 1 + i, tint, d_eye)
        card(out / "found" / "extra_found" / f"rf{991000 + i}", 1 + i, tint, d_eye)
    (Path(root) / "hard_gt.json").write_text(json.dumps(gt, indent=0))
    return out
