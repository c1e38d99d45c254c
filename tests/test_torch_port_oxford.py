"""The port's Oxford-IIIT Pet data path against the JAX package on the CPU,
over a tree written by ``tools/make_smoke_datasets.make_oxford`` (one trimap
emptied, one stored as a palette PNG): ``OxfordIIITPet`` (photos bit-equal
through libjpeg, trimaps, segmentation, labels, big classes, head and body
boxes, the drop of an empty trimap) and both routes of ``OxfordSubset`` (box
only with ``rotate``, ``rotate90`` and both ``big_classes`` layouts; the
mask route with ``rotate90``, and ignoring ``rotate``); the raw-sample PNG
read against PIL's ``np.array(Image.open())``; and ``smoke_data.make_oxford``
against the tool."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu.data_loading import oxford as j_oxford
from pets_face_recognition_tpu_torch import native, smoke_data
from pets_face_recognition_tpu_torch.data_loading.oxford import OxfordIIITPet, OxfordSubset
from pets_face_recognition_tpu_torch.native import png

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
make_smoke_datasets = importlib.import_module("make_smoke_datasets")

torch.set_num_threads(1)

N = 20
EMPTIED, PALETTE = "beagle_4", "Abyssinian_7"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("oxford")
    base = make_smoke_datasets.make_oxford(root, n_imgs=N)
    tri = base / "annotations" / "trimaps"
    Image.fromarray(np.full((320, 320), 2, np.uint8)).save(tri / f"{EMPTIED}.png")
    samples = np.asarray(Image.open(tri / f"{PALETTE}.png"))
    pal = Image.fromarray(samples, mode="L").convert("P")
    pal.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255] + [0] * (3 * 252))
    pal.save(tri / f"{PALETTE}.png")
    assert Image.open(tri / f"{PALETTE}.png").mode == "P"
    return root


def _equal(a, b, what):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _equal(x, y, what)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_png_samples_read_as_pil(tmp_path):
    """Grey, palette, grey + alpha, RGB and RGBA PNGs written by PIL: the
    stored samples equal ``np.array(Image.open())``; a grey PNG the port
    writes opens in PIL as mode L with the same samples."""
    rng = np.random.RandomState(0)
    for i, (mode, shape) in enumerate((("L", (37, 51)), ("P", (64, 33)), ("LA", (19, 23, 2)),
                                       ("RGB", (40, 41, 3)), ("RGBA", (17, 29, 4)))):
        data = rng.randint(0, 256 if mode != "P" else 16, shape).astype(np.uint8)
        path = tmp_path / f"{i}.png"
        img = Image.fromarray(data, mode=mode if mode != "P" else "L")
        if mode == "P":
            img = img.convert("P")
            img.putpalette(list(rng.randint(0, 256, 768)))
        img.save(path)
        want = np.asarray(Image.open(path))
        got = png.read_png_samples(path)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
    gray = rng.randint(0, 256, (30, 45)).astype(np.uint8)
    png.write_png(tmp_path / "g.png", gray)
    back = Image.open(tmp_path / "g.png")
    assert back.mode == "L" and np.array_equal(np.asarray(back), gray)
    assert np.array_equal(png.read_png_samples(tmp_path / "g.png"), gray)


@pytest.mark.parametrize("types", ("category", ("bbox", "big_class"), ("body_bbox",),
                                   ("category", "bbox", "segmentation", "body_bbox",
                                    "big_class")),
                         ids=lambda t: "+".join(t) if isinstance(t, tuple) else t)
def test_dataset_matches_jax(tree, types):
    ours, theirs = OxfordIIITPet(tree, target_types=types), j_oxford.OxfordIIITPet(
        tree, target_types=types)
    # the emptied trimap's image is dropped when body boxes are asked for
    assert len(ours) == len(theirs) == (N - 1 if "body_bbox" in types else N)
    assert ours.classes == theirs.classes and ours.class_to_idx == theirs.class_to_idx
    assert ours.big_classes == theirs.big_classes and set(ours.big_classes) == {0, 1}
    for i in range(len(ours)):
        (img, t), (j_img, j_t) = ours[i], theirs[i]
        _equal(img, j_img, "image")
        _equal(list(t), list(j_t), f"target {i}")
    if "segmentation" in types:
        stems = [p.stem for p in ours._segs]
        seg = ours[stems.index(PALETTE)][1][types.index("segmentation")]
        assert set(np.unique(seg)) == {0, 1}      # palette indices, not colours


BOX_ROUTES = ((("bbox",), dict(rotate=15.0)),
              (("bbox", "body_bbox"), dict(rotate=True, big_classes=True)),
              (("body_bbox",), dict(rotate90=True, big_classes=True)),
              (("bbox", "body_bbox"), dict(rotate90=True)),
              (("bbox",), dict(big_classes=True)))


@pytest.mark.parametrize("types,kw", BOX_ROUTES,
                         ids=lambda v: "+".join(v) if isinstance(v, tuple) else
                         ",".join(f"{k}={x}" for k, x in v.items()))
def test_box_route_matches_jax(tree, types, kw):
    """The same draws, turned images bit-equal, boxes and labels equal, twice
    over the items (the state continues)."""
    base, j_base = OxfordIIITPet(tree, target_types=types), j_oxford.OxfordIIITPet(
        tree, target_types=types)
    idx = list(range(0, len(base), 2))
    a = OxfordSubset(base, idx, seed=3, **kw)
    b = j_oxford.OxfordSubset(j_base, idx, seed=3, **kw)
    turned = set()
    for _ in range(2):
        for i in range(len(a)):
            (img, t), (j_img, j_t) = a[i], b[i]
            _equal(img, j_img, "image")
            assert sorted(t) == sorted(j_t) == ["boxes", "labels"]
            for k in t:
                _equal(t[k], j_t[k], k)
            turned.add(img.shape != base[idx[i]][0].shape
                       or not np.array_equal(img, base[idx[i]][0]))
    assert turned == ({True, False} if "rotate90" in kw else {True} if "rotate" in kw
                      else {False})


@pytest.mark.parametrize("kw", (dict(rotate90=True, big_classes=True), dict(rotate=True)),
                         ids=("rotate90", "rotate-ignored"))
def test_mask_route_matches_jax(tree, kw):
    """``("body_bbox", "segmentation")``: image, box, label and the float32
    mask equal; with ``rotate=True`` nothing turns, as in JAX."""
    types = ("body_bbox", "segmentation")
    base, j_base = OxfordIIITPet(tree, target_types=types), j_oxford.OxfordIIITPet(
        tree, target_types=types)
    idx = list(range(len(base)))
    a = OxfordSubset(base, idx, seed=5, **kw)
    b = j_oxford.OxfordSubset(j_base, idx, seed=5, **kw)
    turned = set()
    for i in range(len(a)):
        (img, t), (j_img, j_t) = a[i], b[i]
        _equal(img, j_img, "image")
        assert sorted(t) == ["boxes", "labels", "masks"] and t["masks"].dtype == np.float32
        for k in t:
            _equal(t[k], j_t[k], k)
        assert t["masks"].shape == (1,) + img.shape[:2]
        turned.add(not np.array_equal(img, base[i][0]))
    assert turned == ({True, False} if "rotate90" in kw else {False})


def test_smoke_make_oxford_writes_the_tools_tree(tmp_path):
    """The same files; XML and split files equal as text, trimaps equal as
    samples (8-bit grey), JPEGs decoding to the tool's pixels."""
    a = make_smoke_datasets.make_oxford(tmp_path / "tool", n_imgs=8)
    b = smoke_data.make_oxford(tmp_path / "port", n_imgs=8)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert len(files) == 8 * 3 + 2
    for rel in files:
        if rel.suffix in (".xml", ".txt"):
            assert (a / rel).read_text() == (b / rel).read_text(), rel
        elif rel.suffix == ".png":
            assert Image.open(b / rel).mode == "L"
            np.testing.assert_array_equal(png.read_png_samples(b / rel),
                                          np.asarray(Image.open(a / rel)), err_msg=str(rel))
        else:
            np.testing.assert_array_equal(native.read_rgb(b / rel),
                                          np.asarray(Image.open(a / rel).convert("RGB")),
                                          err_msg=str(rel))
