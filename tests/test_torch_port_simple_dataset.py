"""The dog-annotation ``SimpleDataset`` and the keypoint config's dog-fixture
branch of the port against the JAX package's on the CPU.

The ``data_25`` photos are ``smoke_data.make_data25``'s (320 x 320 JPEGs);
the test writes seeded ``paths`` / ``others`` pickles over them (Windows
separators in half the paths, one or two boxes a photo, a hidden keypoint
among them) next to the committed 40-photo CAT miniature. Checked, at
``num_workers=0`` (under loader threads the rot90 draws follow the threads'
order, ROADMAP note 10): every item of ``SimpleDataset`` with and without
rot90 and through a transform equal to JAX's (the photos decode bit-equal
to PIL); and ``build_keypoint_config`` with both pickle pairs present
concatenates them after the CAT training part, its training set equal to
JAX's item for item and its loader's batches equal over an epoch (the
letterboxed images within one level, as ``DetectionCollate`` is held).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu import config_presets as j_presets
from pets_face_recognition_tpu.data_loading.dataset import SimpleDataset as JSimpleDataset
from pets_face_recognition_tpu_torch import config_presets, smoke_data
from pets_face_recognition_tpu_torch.data_loading import ConcatDataset, SimpleDataset

torch.set_num_threads(1)

CAT = Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch" / "testdata" \
    / "CAT_DATASET"


def tables(root: Path, seed: int):
    """Seeded ``paths`` and ``others`` over the photos of ``root/data_25``."""
    rng = np.random.RandomState(seed)
    photos = sorted(p.relative_to(root / "data_25") for p in (root / "data_25").rglob("*.jpg"))
    paths, others = [], []
    for i, rel in enumerate(photos[: 8 + seed % 3]):
        paths.append(str(rel).replace("/", "\\") if i % 2 else str(rel))
        n = 1 + i % 2
        x1, y1 = rng.uniform(0, 200, (2, n))
        w, h = rng.uniform(40, 110, (2, n))
        boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).round().astype(int)
        kps = np.stack([x1[:, None] + rng.uniform(0.1, 0.9, (n, 3)) * w[:, None],
                        y1[:, None] + rng.uniform(0.1, 0.9, (n, 3)) * h[:, None],
                        np.ones((n, 3))], -1)
        kps[0, 2, 2] = 0.0 if i % 3 == 0 else 1.0
        others.append({"boxes": boxes.tolist(), "labels": [0] * n, "keypoints": kps.tolist()})
    return paths, others


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dogs")
    (root / "CAT_DATASET").symlink_to(CAT, target_is_directory=True)
    smoke_data.make_data25(root)
    for suffix, seed in (("", 1), ("2", 2)):
        paths, others = tables(root, seed)
        (root / f"paths{suffix}.pickle").write_bytes(pickle.dumps(paths))
        (root / f"others{suffix}.pickle").write_bytes(pickle.dumps(others))
    return root


def _equal_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        (g_img, g_t), (w_img, w_t) = got[i], want[i]
        np.testing.assert_array_equal(g_img, w_img, err_msg=str(i))
        assert sorted(g_t) == sorted(w_t)
        for k in w_t:
            assert np.asarray(g_t[k]).dtype == np.asarray(w_t[k]).dtype, (i, k)
            np.testing.assert_array_equal(g_t[k], w_t[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("rotate90", [False, True])
def test_simple_dataset_matches_jax(root, rotate90):
    """Every item, twice over (the rot90 draws go on from one ``RandomState``):
    the photo, int64 boxes, float keypoints and labels equal to JAX's."""
    paths, others = tables(root, 1)
    got = SimpleDataset(root / "data_25", paths, others, rotate90=rotate90,
                        rng=np.random.RandomState(7))
    want = JSimpleDataset(root / "data_25", paths, others, rotate90=rotate90,
                          rng=np.random.RandomState(7))
    for _ in range(2):
        _equal_items(got, want)
    assert got[0][0].shape == (320, 320, 3)


def test_simple_dataset_transform_matches_jax(root):
    paths, others = tables(root, 2)

    def transform(image, targets):
        return image[::2, ::2], {**targets, "boxes": targets["boxes"] // 2}

    _equal_items(SimpleDataset(root / "data_25", paths, others, transform=transform),
                 JSimpleDataset(root / "data_25", paths, others, transform=transform))


def test_keypoint_config_with_dog_fixtures_matches_jax(root, tmp_path):
    """Both pickle pairs found: the CAT training part, then the two dog
    tables; the training set and every batch of an epoch of its loader
    (B = 4 at 96 x 96, no worker threads) equal to JAX's."""
    kw = dict(data_root=str(root), fixtures_dir=str(root), train_batch_size=4,
              image_size=(96, 96), num_workers=0)
    got = config_presets.build_keypoint_config(output=str(tmp_path / "port"), **kw)
    want = j_presets.build_keypoint_config(output=str(tmp_path / "jax"), **kw)
    g_ds, w_ds = got["train_dataloader"]().dataset, want["train_dataloader"]().dataset
    assert isinstance(g_ds, ConcatDataset) and len(g_ds.datasets) == 3
    assert [len(d) for d in g_ds.datasets] == [32, 9, 10]
    assert all(isinstance(d, SimpleDataset) and d.rotate90 for d in g_ds.datasets[1:])
    _equal_items(g_ds, w_ds)
    got, want = (config_presets.build_keypoint_config(output=str(tmp_path / "port"), **kw),
                 j_presets.build_keypoint_config(output=str(tmp_path / "jax"), **kw))
    g_batches, w_batches = list(got["train_dataloader"]()), list(want["train_dataloader"]())
    assert len(g_batches) == len(w_batches) == 51 // 4
    for g, w in zip(g_batches, w_batches):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "images":
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
        # the collate's letterbox: F.interpolate against cv2's fixed-point
        # uint8 resize, within a level (test_torch_port_det_data.py)
        assert np.abs(np.asarray(g["images"]) - np.asarray(w["images"])).max() <= 1 / 255 + 1e-6


def test_keypoint_config_without_fixtures_keeps_the_cat_set(root, tmp_path):
    got = config_presets.build_keypoint_config(data_root=str(root), fixtures_dir=str(tmp_path),
                                               output=str(tmp_path / "o"), num_workers=0)
    ds = got["train_dataloader"]().dataset
    assert not isinstance(ds, ConcatDataset) and len(ds) == 32
