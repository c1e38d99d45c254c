"""The port's detection data path against the JAX package on the CPU: the CAT
landmark dataset on the committed miniature, its rot90 augmentation, the
detection collate, the loader's batch order, and the detection metrics
(whose AP the JAX package takes from scikit-learn and the port computes
itself)."""

import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu.data_loading import dataset as j_dataset
from pets_face_recognition_tpu.data_loading import lmd_dataset as j_lmd
from pets_face_recognition_tpu.data_loading.loader import DataLoader as JDataLoader
from pets_face_recognition_tpu.engine import detection_metrics as j_metrics
from pets_face_recognition_tpu.utils import collate as j_collate
from pets_face_recognition_tpu_torch import native
from pets_face_recognition_tpu_torch.data_loading import (CatLMDDataset, CatLMDSubset,
                                                          ConcatDataset, DataLoader,
                                                          default_collate)
from pets_face_recognition_tpu_torch.data_loading.lmd_dataset import read_jpeg
from pets_face_recognition_tpu_torch.engine import detection_metrics as metrics
from pets_face_recognition_tpu_torch.utils.collate import DetectionCollate

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch" / "testdata"
CAT = TESTDATA / "CAT_DATASET"
GRAY = TESTDATA / "jpeg_variants" / "gray_47x33.jpg"


@pytest.fixture(scope="module")
def datasets():
    if native.route() != "libjpeg":
        pytest.skip("bit-equality with PIL needs the libjpeg route")
    return CatLMDDataset(CAT), j_lmd.CatLMDDataset(CAT)


def test_cat_dataset_matches_jax_on_the_miniature(datasets):
    """All 40 photos of the committed miniature: the same paths, images
    bit-equal (libjpeg, as PIL) and the synthesised box, keypoints and labels
    equal."""
    ours, theirs = datasets
    assert len(ours) == len(theirs) == 40
    assert ours.paths == theirs.paths
    for i in range(len(ours)):
        (img, t), (j_img, j_t) = ours[i], theirs[i]
        assert img.dtype == np.uint8 and img.shape == j_img.shape == (320, 320, 3)
        np.testing.assert_array_equal(img, j_img)
        assert sorted(t) == sorted(j_t)
        for k in t:
            assert t[k].dtype == j_t[k].dtype, k
            np.testing.assert_array_equal(t[k], j_t[k], err_msg=f"{k} {i}")


def test_gray_jpeg_comes_back_two_dimensional(tmp_path):
    """A one-component JPEG reads as ``(H, W)``, as PIL gives it, so that the
    collate's gray -> RGB branch runs; the dataset reads it so too."""
    np.testing.assert_array_equal(read_jpeg(GRAY), np.array(Image.open(GRAY)))
    assert native.jpeg_components(GRAY) == 1
    assert native.jpeg_components(TESTDATA / "jpeg_variants" / "420_61x83.jpg") == 3
    d = tmp_path / "CAT_DATASET" / "CAT_00"
    d.mkdir(parents=True)
    shutil.copy(GRAY, d / "g.jpg")
    (d / "g.jpg.cat").write_text("9 10 12 30 12 20 25 1 1 2 2 3 3 4 4 5 5 6 6")
    img, t = CatLMDDataset(tmp_path / "CAT_DATASET")[0]
    j_img, j_t = j_lmd.CatLMDDataset(tmp_path / "CAT_DATASET")[0]
    assert img.shape == (47, 33)
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(t["boxes"], j_t["boxes"])


def test_rot90_subset_draws_the_jax_sequence(datasets):
    """``CatLMDSubset(rotate90=True, seed)``: the same k draws, images,
    boxes and keypoints over every item, twice over (the state continues)."""
    ours, theirs = datasets
    idx = list(range(0, 40, 3))
    a = CatLMDSubset(ours, idx, rotate90=True, seed=5)
    b = j_lmd.CatLMDSubset(theirs, idx, rotate90=True, seed=5)
    turned = set()
    for _ in range(2):
        for i in range(len(a)):
            (img, t), (j_img, j_t) = a[i], b[i]
            np.testing.assert_array_equal(img, j_img)
            for k in ("boxes", "keypoints", "labels"):
                assert t[k].dtype == j_t[k].dtype
                np.testing.assert_array_equal(t[k], j_t[k], err_msg=k)
            turned.add(not np.array_equal(img, ours[idx[i]][0]))
    assert turned == {True, False}      # some items turned, some not
    # rotate and rotate90 exclude each other, as in JAX
    with pytest.raises(AssertionError):
        CatLMDSubset(ours, idx, rotate=15, rotate90=True)


def test_concat_dataset_indexes_as_jax():
    """Every index, negative ones too, reaches the same part and item; past
    the end raises as in JAX."""
    parts = [list(range(3)), [], list(range(10, 15)), [99]]
    ours, theirs = ConcatDataset(parts), j_dataset.ConcatDataset(parts)
    assert len(ours) == len(theirs) == 9
    assert [ours[i] for i in range(-9, 9)] == [theirs[i] for i in range(-9, 9)]
    with pytest.raises(IndexError):
        ours[-10]


def _samples(rng):
    """Photos of several shapes and ranges, with 0-3 boxes and keypoints."""
    out = []
    for h, w, kind in ((320, 320, "u8"), (200, 300, "u8"), (47, 33, "gray"),
                       (90, 60, "rgba"), (64, 80, "dark")):
        if kind == "gray":
            img = rng.randint(0, 256, (h, w), np.uint8)
        elif kind == "rgba":
            img = rng.randint(0, 256, (h, w, 4), np.uint8)
        elif kind == "dark":                       # [0, 1] floats: not divided by 255
            img = rng.rand(h, w, 3).astype(np.float32)
        else:
            img = rng.randint(0, 256, (h, w, 3), np.uint8)
        n = rng.randint(0, 4)
        xy = rng.rand(n, 2) * [w / 2, h / 2]
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * [w / 2, h / 2]], 1)
        kps = np.concatenate([rng.rand(n, 3, 2) * [w, h], np.ones((n, 3, 1))], -1)
        out.append((img, {"boxes": boxes.astype(np.float32),
                          "keypoints": kps.astype(np.float32),
                          "labels": np.zeros(n, np.int32)}))
    return out


@pytest.mark.parametrize("size,max_boxes", [((640, 640), 4), ((96, 128), 2)])
def test_detection_collate_matches_jax(size, max_boxes):
    """Boxes, keypoints, labels and valid within 1e-5; images within 1/255
    (cv2's fixed-point uint8 resize against ``F.interpolate``); the gray,
    RGBA and [0, 1] samples take the JAX branches."""
    samples = _samples(np.random.RandomState(size[0]))
    got = DetectionCollate(size, max_boxes=max_boxes, num_keypoints=3)(samples)
    want = j_collate.DetectionCollate(size, max_boxes=max_boxes, num_keypoints=3)(samples)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("boxes", "keypoints", "labels", "valid"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert np.abs(got["images"] - want["images"]).max() <= 1 / 255 + 1e-6
    assert got["images"][4].max() <= 1.0 and got["images"][0].max() <= 1.0


class _Indexed:
    def __len__(self):
        return 21

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full(2, i, np.float32)}


def test_loader_order_matches_jax_over_two_epochs():
    """Shuffled with ``drop_last``: the same batches in two epochs (epoch e
    shuffles with ``RandomState(seed + e)``) and the same ``len``; unshuffled
    without it the last short batch is kept. The threaded loader yields the
    same batches in the same order."""
    ds = _Indexed()
    for kw in (dict(shuffle=True, seed=3, drop_last=True), dict(shuffle=False)):
        ours = DataLoader(ds, 4, num_workers=0, **kw)
        theirs = JDataLoader(ds, 4, num_workers=0, **kw)
        threaded = DataLoader(ds, 4, num_workers=3, **kw)
        assert len(ours) == len(theirs) == len(threaded) == (5 if kw["shuffle"] else 6)
        epochs = []
        for _ in range(2):
            a, b, c = list(ours), list(theirs), list(threaded)
            assert len(a) == len(b) == len(c) == len(ours)
            for x, y, z in zip(a, b, c):
                np.testing.assert_array_equal(x["i"], y["i"])
                np.testing.assert_array_equal(x["x"], y["x"])
                np.testing.assert_array_equal(z["i"], y["i"])
            epochs.append(np.concatenate([x["i"] for x in a]))
        assert (epochs[0] != epochs[1]).any() == kw["shuffle"]
    assert default_collate([(1, 2), (3, 4)])[0].tolist() == [1, 3]


def test_loader_thread_ends_when_the_consumer_stops_early():
    """Breaking out of a threaded epoch (as ``limit_train_batches`` does)
    ends the producer thread; a worker's exception reaches the consumer."""
    before = threading.active_count()
    loader = DataLoader(_Indexed(), 2, num_workers=2, prefetch=1)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert threading.active_count() == before

    class Broken(_Indexed):
        def __getitem__(self, i):
            raise OSError(f"cannot decode {i}")

    with pytest.raises(OSError, match="cannot decode"):
        list(DataLoader(Broken(), 2, num_workers=2))
    assert threading.active_count() == before


def _predictions(rng, n_images, tie_scores):
    preds, trues = [], []
    for b in range(n_images):
        n_gt = rng.randint(0, 3)
        xy = rng.rand(n_gt, 2) * 80
        gt = np.concatenate([xy, xy + 10 + rng.rand(n_gt, 2) * 40], 1)
        n_dt = rng.randint(0, 4)
        dt = np.concatenate([gt, np.zeros((0, 4))])[:n_dt] + rng.randn(min(n_dt, n_gt), 4) * 6
        extra = rng.rand(n_dt - len(dt), 4) * 60
        dt = np.concatenate([dt, np.concatenate([extra[:, :2], extra[:, :2] + 20], 1)])
        scores = (rng.randint(0, 3, n_dt) / 2 if tie_scores else rng.rand(n_dt))
        order = np.argsort(-scores, kind="stable")
        preds.append({"boxes": dt[order].astype(np.float32), "labels": np.ones(n_dt, int),
                      "scores": scores[order].astype(np.float32),
                      "keypoints": rng.rand(n_dt, 3, 3).astype(np.float32) * 90})
        trues.append({"boxes": gt.astype(np.float32), "labels": np.ones(n_gt, int),
                      "keypoints": rng.rand(n_gt, 3, 3).astype(np.float32) * 90})
    return preds, trues


@pytest.mark.parametrize("case", ["ties", "distinct", "all_hits", "all_misses", "empty"])
def test_detection_metrics_match_jax(case):
    """AP 50 / 70 / 90, the top detection's IoU and the keypoint errors
    against the JAX file (AP from scikit-learn) within 1e-12: tied scores,
    distinct scores, every flag 1, every flag 0, and images with no
    detection or no ground truth."""
    rng = np.random.RandomState(len(case))
    preds, trues = _predictions(rng, 12, tie_scores=case == "ties")
    if case == "all_hits":
        preds = [{**t, "scores": rng.rand(len(t["boxes"])).astype(np.float32)} for t in trues]
    elif case == "all_misses":
        preds = [{**p, "boxes": p["boxes"] + 500} for p in preds]
    elif case == "empty":
        preds = [{k: v[:0] for k, v in p.items()} if i % 2 else p for i, p in enumerate(preds)]
        trues = [{k: v[:0] for k, v in t.items()} if i % 3 == 0 else t
                 for i, t in enumerate(trues)]
    got = metrics.detection_metrics(preds, trues, with_keypoints=True)
    want = j_metrics.detection_metrics(preds, trues, with_keypoints=True)
    assert list(got) == list(want)
    for k in got:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    flags = rng.randint(0, 2, 50)
    flags[:2] = (0, 1)
    scores = rng.randint(0, 5, 50) / 4
    assert abs(metrics.average_precision(flags, scores)
               - j_metrics.average_precision_score(flags, scores)) <= 1e-12


def test_native_library_builds_once_under_concurrent_first_use(monkeypatch, tmp_path):
    """A loader's threads all reach the JPEG library on their first photo:
    with no library built yet, 16 threads decoding at once (a short switch
    interval) get one build and the same pixels, within 120 s."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    if native.route() is None:
        pytest.skip("no native JPEG route on this host")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._load.cache_clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        paths = sorted((CAT / "CAT_00").glob("*.jpg"))[:4] * 4
        with ThreadPoolExecutor(16) as pool:
            images = list(pool.map(read_jpeg, paths, timeout=120))
    finally:
        sys.setswitchinterval(interval)
        native._load.cache_clear()
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*tmp*"))
    for p, img in zip(paths, images):
        np.testing.assert_array_equal(img, images[paths.index(p)])
