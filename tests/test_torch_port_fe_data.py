"""The feature extractor's data path in the port against PIL, the JAX package
and ``tools/make_smoke_datasets.py`` on the CPU:

- each ``FETrainAug`` operation bit-equal to PIL 12 on uint8 images over many
  draws, and the whole augmentation bit-equal to the JAX ``FETrainAug`` for
  the same ``RandomState``;
- PNG read and write against PIL; the libjpeg JPEG encoder decoding to PIL's
  quality-75 pixels; ``smoke_data``'s writers against the tool's;
- ``RecDataset``'s maps, items and labels and ``PairGenerator``'s pairs equal
  to JAX's for several seeds; ``build_fe_config`` equal to JAX's (split,
  labels, classes, pairs, the first training and validation batches).
"""

import importlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from pets_face_recognition_tpu.config_presets import build_fe_config as j_build_fe_config
from pets_face_recognition_tpu.data_loading import PairGenerator as JPairGenerator
from pets_face_recognition_tpu.data_loading import RecDataset as JRecDataset
from pets_face_recognition_tpu.data_loading.dataset import simple_init_dataset as j_simple
from pets_face_recognition_tpu.utils.preprocs import FETrainAug as JFETrainAug
from pets_face_recognition_tpu_torch import native, smoke_data
from pets_face_recognition_tpu_torch.config_presets import build_fe_config
from pets_face_recognition_tpu_torch.data_loading import (PairGenerator, RecDataset,
                                                          simple_init_dataset)
from pets_face_recognition_tpu_torch.native import png
from pets_face_recognition_tpu_torch.utils import preprocs

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
make_smoke_datasets = importlib.import_module("make_smoke_datasets")

torch.set_num_threads(1)


def images(seed, n):
    """uint8 RGB images of many sizes, full-range noise and narrow-range
    smooth ones (autocontrast stretches those)."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = (224, 224) if i % 3 == 0 else rng.randint(3, 90, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 2:
            img = (img // rng.randint(2, 12) + rng.randint(0, 140)).astype(np.uint8)
        yield rng, img


def _pil_op(op, pil, rng):
    if op == "smooth":
        return None, ImageEnhance.Sharpness(pil).enhance(0.0)
    if op == "autocontrast":
        return None, ImageOps.autocontrast(pil)
    if op == "resize":
        size = tuple(int(v) for v in rng.randint(1, 260, 2))
        return size, pil.resize(size, Image.BILINEAR)
    angle = rng.uniform(-5, 5) if rng.rand() < 0.8 else rng.choice(
        [0.0, 90.0, 180.0, 270.0, rng.uniform(-360, 360)])
    return angle, pil.rotate(angle, resample=Image.NEAREST)


@pytest.mark.parametrize("op", ["smooth", "autocontrast", "resize", "rotate"])
def test_fe_aug_ops_bit_equal_to_pil(op):
    """Sharpness(0) (the SMOOTH filter), autocontrast, bilinear resize and
    nearest rotation, each on 60 images: every pixel equal."""
    fn = {"smooth": lambda im, a: preprocs.smooth(im),
          "autocontrast": lambda im, a: preprocs.autocontrast(im),
          "resize": preprocs.resize_bilinear, "rotate": preprocs.rotate_nearest}[op]
    for rng, img in images({"smooth": 1, "autocontrast": 2, "resize": 3, "rotate": 4}[op], 60):
        arg, want = _pil_op(op, Image.fromarray(img), rng)
        got = fn(img, arg)
        assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(want)), (op, img.shape,
                                                                                arg)


def test_fe_train_aug_bit_equal_to_jax():
    """The whole augmentation, 200 draws from one seeded ``RandomState`` on
    each side, on 224 x 224 crops (as the corpus holds) and a smaller one
    (no crop): float32 outputs equal, and the generators end in one state."""
    port, jax_aug = (preprocs.FETrainAug(np.random.RandomState(5)),
                     JFETrainAug(np.random.RandomState(5)))
    for i, (_, img) in enumerate(images(6, 200)):
        if i % 7 == 3:
            img = img[:200, :210] if img.shape[0] >= 200 else img
        got, want = port(img), jax_aug(img)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), i
    assert port.rng.randint(1 << 30) == jax_aug.rng.randint(1 << 30)
    img = next(images(7, 1))[1]
    assert np.array_equal(preprocs.FEValAug()(img), np.asarray(img, np.float32) / 255.0)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_reads_pil_files(tmp_path, mode):
    """PIL-written PNGs (its adaptive row filters: None, Sub, Up, Average and
    Paeth all occur) read as PIL's ``convert("RGB")``."""
    for i, (_, img) in enumerate(images(8, 8)):
        if mode == "P":
            pil = Image.fromarray(img).quantize(37)
        else:
            pil = Image.fromarray(img).convert(mode)
        path = tmp_path / f"{i}.png"
        pil.save(path)
        assert np.array_equal(png.read_png(path), np.asarray(Image.open(path).convert("RGB")))


def test_png_write_round_trips_through_pil(tmp_path):
    for i, (_, img) in enumerate(images(9, 10)):
        path = tmp_path / f"{i}.png"
        png.write_png(path, img)
        assert np.array_equal(np.asarray(Image.open(path)), img)
        assert np.array_equal(png.read_png(path), img)
    with pytest.raises(OSError):
        native.read_rgb(Path(__file__))


@pytest.mark.skipif(native.route() != "libjpeg", reason="needs the libjpeg route")
def test_libjpeg_encoder_decodes_to_pil_q75_pixels():
    """PIL's default JPEG save (quality 75, 4:2:0) and the port's encoder give
    the same pixels once decoded by PIL, at several sizes and qualities."""
    for i, (_, img) in enumerate(images(10, 12)):
        q = (75, 92, 30)[i % 3]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=q)
        ours = native.encode_jpeg(img, q)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(ours))),
                              np.asarray(Image.open(buf))), (img.shape, q)
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4), np.uint8))


def test_smoke_writers_match_the_tool(tmp_path):
    """``make_fe``, ``make_data25`` and ``make_petfinder_extras``: the same
    files, each decoding to the tool's pixels."""
    a, b = tmp_path / "tool", tmp_path / "port"
    for name in ("make_fe", "make_data25", "make_petfinder_extras"):
        getattr(make_smoke_datasets, name)(a)
        getattr(smoke_data, name)(b)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".json":
            assert (a / rel).read_text() == (b / rel).read_text()
        else:
            assert np.array_equal(native.read_rgb(b / rel),
                                  np.asarray(Image.open(a / rel).convert("RGB"))), rel


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("fe_corpora")
    smoke_data.make_fe(root, n_ids=10, n_imgs=4, size=64)
    smoke_data.make_data25(root)
    smoke_data.make_petfinder_extras(root)
    return root


def _same_dataset(port, jax_ds):
    assert {k: str(v) for k, v in port.uid_to_user.items()} == {
        k: str(v) for k, v in jax_ds.uid_to_user.items()}
    assert {k: str(v) for k, v in port.index_to_path.items()} == {
        k: str(v) for k, v in jax_ds.index_to_path.items()}
    assert port.index_to_uid == jax_ds.index_to_uid
    assert port.uid_to_indices == jax_ds.uid_to_indices
    assert port.label_map == jax_ds.label_map and port.get_users() == jax_ds.get_users()


@pytest.mark.parametrize("layout", ["fe", "data25_dogs", "data25_cats", "extras"])
def test_rec_dataset_equals_jax(corpora, layout):
    """The uid and index maps, labels and items (``x`` equal) of the simple
    scan (FE corpora, with ``start_class``) and of the validating scan with
    animal types and an exclusion list (data_25)."""
    if layout == "fe":
        args = (corpora / "smoke_fe_cats", None, 3)
        kw = dict(start_class=4)
        port = RecDataset(*args, init_dataset_method=simple_init_dataset, **kw)
        want = JRecDataset(*args, init_dataset_method=j_simple, **kw)
    elif layout == "extras":
        args = (corpora / "petfinder_extra_dogs", None, 1)
        port = RecDataset(*args, init_dataset_method=simple_init_dataset)
        want = JRecDataset(*args, init_dataset_method=j_simple)
    else:
        exclude = [corpora / "data_25" / "rl131336" / "216319.jpg"]
        args = (corpora / "data_25", 1 if layout == "data25_dogs" else 2, 1)
        port = RecDataset(*args, paths_to_exclude=exclude)
        want = JRecDataset(*args, paths_to_exclude=exclude)
    _same_dataset(port, want)
    assert len(port) == len(want) > 0
    for i in range(len(port)):
        got, ref = port[i], want[i]
        assert got["label"] == ref["label"] and got["index"] == ref["index"]
        assert np.array_equal(got["x"], ref["x"])


@pytest.mark.parametrize("seed", [0, 1, 123])
def test_pair_generator_equals_jax(corpora, seed, tmp_path):
    """Positives then negatives, the correction map and the labels, for
    several seeds and identity subsets; the pickle cache reads back."""
    ds = RecDataset(corpora / "smoke_fe_cats", None, 3, init_dataset_method=simple_init_dataset)
    j_ds = JRecDataset(corpora / "smoke_fe_cats", None, 3, init_dataset_method=j_simple)
    users = list(np.random.RandomState(seed).permutation(ds.get_users())[:6])
    for n in (None, 20, 50):
        got = PairGenerator(ds, n, 1, None, seed, users)
        want = JPairGenerator(j_ds, n, 1, None, seed, users)
        assert got.pairs == want.pairs and got.correction == want.correction
        assert got.corrected_indices == want.corrected_indices
        assert np.array_equal(got.labels, want.labels)
    cache = tmp_path / "pairs.pkl"
    made = PairGenerator(ds, 30, 1, cache, seed, users)
    assert PairGenerator(ds, 30, 1, cache, 999, users).pairs == made.pairs
    assert set(got[0]) == {"x1", "x2", "label"}


def test_build_fe_config_equals_jax(corpora, tmp_path):
    """The 50/50 identity split, the relabelling, the extras through
    ``ConcatDataset`` with ``start_class``, ``num_classes``, the pairs, the
    metric knobs, and the first training batch (shuffled, augmented: equal
    bits) and validation batch of each config, read in one thread."""
    kw = dict(dataset_dir=str(corpora / "smoke_fe_cats"),
              extra_dataset_dir=str(corpora / "petfinder_extra_cats"), seed=7,
              train_batch_size=8, test_batch_size=8, num_workers=0, n_pairs=40)
    got = build_fe_config(output=str(tmp_path / "port"), **kw)
    want = j_build_fe_config(output=str(tmp_path / "jax"), **kw)
    # 5 training identities and the one extras card with 3 images (min_number 3)
    assert got["num_classes"] == want["num_classes"] == 5 + 1
    assert got["dataset"].label_map == want["dataset"].label_map
    for k in ("thrs", "far_thr", "k", "n_epochs", "seed", "emb_size"):
        assert np.array_equal(got[k], want[k]), k
    gp, wp = got["pair_generator"](0)[1], want["pair_generator"](0)[1]
    assert got["pair_generator"](0)[0] == "Val" and gp.pairs == wp.pairs
    for loader in ("train_dataloader", "val_dataloader"):
        a, b = got[loader](), want[loader]()
        assert len(a) == len(b)
        ba, bb = next(iter(a)), next(iter(b))
        for k in ("x", "label", "index"):
            assert np.array_equal(ba[k], bb[k]), (loader, k)
