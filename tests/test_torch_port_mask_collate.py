"""The collate's masks against cv2 and the JAX package on the CPU:
``resize_linear_f32`` bit-equal to ``cv2.resize(..., INTER_LINEAR)`` on
float32 masks and float planes (upscale, downscale, exactly half, integer and
non-integer ratios, portrait and landscape); ``letterbox_mask`` and the
collated ``masks`` of ``detection_collate(with_masks=True)`` bit-equal to
JAX's, and so their ``astype(int)`` counts (what ``mask_iou`` reads) and
their ``> 0.5`` cuts (what ``maskrcnn_loss`` reads) too."""

import cv2
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.utils import collate as j_collate
from pets_face_recognition_tpu_torch.utils.collate import (DetectionCollate, detection_collate,
                                                           letterbox_mask, resize_linear_f32)

torch.set_num_threads(1)

RESIZES = ((320, 320, 640, 640), (640, 640, 320, 320), (500, 375, 640, 480),
           (375, 500, 480, 640), (97, 131, 64, 86), (33, 47, 100, 142), (300, 200, 213, 142),
           (480, 640, 240, 320), (7, 9, 64, 82), (1000, 750, 640, 480), (2, 3, 50, 70),
           (333, 500, 426, 640), (90, 30, 270, 90), (64, 64, 64, 64))


def _plane(rng, h, w, kind):
    if kind == "mask":
        yy, xx = np.mgrid[:h, :w]
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        return (((xx - cx) / max(w / 3, 1)) ** 2 + ((yy - cy) / max(h / 4, 1)) ** 2
                < 1).astype(np.float32)
    return rng.rand(h, w).astype(np.float32)


@pytest.mark.parametrize("kind", ("mask", "noise"))
def test_resize_linear_f32_is_cv2_bit_for_bit(kind):
    rng = np.random.RandomState(0 if kind == "mask" else 1)
    sizes = list(RESIZES) + [tuple(rng.randint(2, 400, 2)) + tuple(rng.randint(2, 700, 2))
                             for _ in range(12)]
    for h, w, nh, nw in sizes:
        img = _plane(rng, h, w, kind)
        want = cv2.resize(img, (int(nw), int(nh)), interpolation=cv2.INTER_LINEAR)
        got = resize_linear_f32(img, (nh, nw))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), ((h, w, nh, nw), int((got != want).sum()))
    with pytest.raises(ValueError):
        resize_linear_f32(np.zeros((4, 4, 3), np.float32), (8, 8))


def test_letterbox_mask_is_jax_bit_for_bit():
    rng = np.random.RandomState(2)
    for (h, w) in ((320, 320), (500, 375), (375, 500), (97, 131), (33, 47), (1200, 90)):
        for size in ((640, 640), (320, 320), (256, 384)):
            m = _plane(rng, h, w, "mask")
            want, _, _ = j_collate.letterbox_image(m, size)
            got = letterbox_mask(m, size)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), ((h, w), size)
            assert (got.astype(int) == 1).sum() == (want.astype(int) == 1).sum()


def _samples(rng):
    """Photos of several shapes, each with 1-3 boxes and their 0/1 masks."""
    out = []
    for h, w in ((320, 320), (375, 500), (500, 333), (97, 131), (640, 427)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        n = rng.randint(1, 4)
        masks = np.stack([_plane(rng, h, w, "mask") for _ in range(n)])
        x1, y1 = rng.uniform(0, w / 2, n), rng.uniform(0, h / 2, n)
        boxes = np.stack([x1, y1, x1 + w / 3, y1 + h / 3], 1).astype(np.float32)
        out.append((img, {"boxes": boxes, "labels": np.arange(n, dtype=np.int32),
                          "masks": masks}))
    return out


@pytest.mark.parametrize("size", ((640, 640), (320, 320), (300, 400)), ids=str)
def test_collated_masks_match_jax(size):
    samples = _samples(np.random.RandomState(3))
    got = DetectionCollate(size, max_boxes=2, with_masks=True)(samples)
    want = j_collate.detection_collate(samples, size, max_boxes=2, with_masks=True)
    assert sorted(got) == sorted(want)
    for k in ("masks", "boxes", "labels", "valid"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert got["masks"].shape == (len(samples), 2) + size
    assert np.array_equal(got["masks"].astype(int), want["masks"].astype(int))
    assert np.array_equal(got["masks"] > 0.5, want["masks"] > 0.5)
    # the images keep the letterbox's documented +-1 of 255 (a uint8 resize)
    assert np.abs(got["images"] - want["images"]).max() <= 1 / 255 + 1e-6
    assert "masks" not in detection_collate(samples, size, max_boxes=2)
