"""The port's rotation (``data_loading/transforms.py``) against cv2 and the
JAX package on the CPU: ``rotate_image`` bit-equal to ``cv2.warpAffine``
(``INTER_NEAREST``, ``BORDER_REFLECT_101``) over right, small, odd and seeded
random angles, on odd and even sizes, 3-channel and 2-D uint8; the rotation
matrix equal to ``cv2.getRotationMatrix2D``; ``rotate_points`` and
``rotate_bbox`` within 1e-9 of JAX's; and ``CatLMDSubset(rotate=20.0,
seed=7)`` equal to JAX's over the CAT miniature."""

import cv2
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.data_loading import lmd_dataset as j_lmd
from pets_face_recognition_tpu.data_loading import transforms as j_tf
from pets_face_recognition_tpu_torch.data_loading import CatLMDDataset, CatLMDSubset
from pets_face_recognition_tpu_torch.data_loading import transforms as tf

from test_torch_port_det_entry import PORT

torch.set_num_threads(1)

SIZES = ((31, 47), (64, 64), (33, 20), (100, 157), (320, 320), (375, 500), (1, 7))
ANGLES = (0.0, 15.0, -15.0, 45.0, 90.0, -90.0, 180.0, 7.3)


def _angles(seed):
    return ANGLES + tuple(np.random.RandomState(seed).uniform(-180, 180, 6))


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("channels", (3, None), ids=("rgb", "gray"))
def test_rotate_image_is_cv2_warp_affine_bit_for_bit(hw, channels):
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w)
    img = rng.randint(0, 256, (h, w, channels) if channels else (h, w)).astype(np.uint8)
    for angle in _angles(h + w):
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
        np.testing.assert_array_equal(tf.rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle), m)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_REFLECT_101)
        got = tf.rotate_image(img, angle)
        assert got.dtype == np.uint8 and got.shape == img.shape
        assert np.array_equal(got, want), (angle, int((got != want).sum()))
        assert np.array_equal(got, j_tf.rotate_image(img, angle))


def test_rotate_points_and_bbox_match_jax():
    rng = np.random.RandomState(4)
    for (h, w) in SIZES[:5]:
        pts = rng.uniform(-20, max(h, w) + 20, (7, 2))
        box = np.sort(rng.uniform(0, min(h, w), 4).reshape(2, 2), axis=0).T.reshape(-1)
        box = np.array([box[0], box[2], box[1], box[3]])
        for angle in _angles(w):
            np.testing.assert_allclose(tf.rotate_points(pts, angle, (h, w)),
                                       j_tf.rotate_points(pts, angle, (h, w)), rtol=0, atol=1e-9)
            np.testing.assert_allclose(tf.rotate_bbox(box, angle, (h, w)),
                                       j_tf.rotate_bbox(box, angle, (h, w)), rtol=0, atol=1e-9)


def test_cat_lmd_subset_rotate_matches_jax():
    """``CatLMDSubset(rotate=20.0, seed=7)``: the same angle draws, turned
    images bit-equal, boxes, keypoints (with visibility) and labels equal,
    twice over the items (the state continues)."""
    root = PORT / "testdata" / "CAT_DATASET"
    ours, theirs = CatLMDDataset(root), j_lmd.CatLMDDataset(root)
    idx = list(range(0, 40, 5))
    a = CatLMDSubset(ours, idx, rotate=20.0, seed=7)
    b = j_lmd.CatLMDSubset(theirs, idx, rotate=20.0, seed=7)
    for _ in range(2):
        for i in range(len(a)):
            (img, t), (j_img, j_t) = a[i], b[i]
            np.testing.assert_array_equal(img, j_img)
            for k in ("boxes", "keypoints", "labels"):
                assert t[k].dtype == j_t[k].dtype, k
                np.testing.assert_array_equal(t[k], j_t[k], err_msg=k)
    assert CatLMDSubset(ours, idx, rotate=True).rotate == 15.0
