"""The port's aligned-corpus transform (``transform_reproduce``, head route)
against the JAX package's ``transform_reproduce.py`` on the CPU, over the
``make_data25`` and ``make_petfinder_extras`` layouts, with one set of
detector weights (JAX variables carried over with ``weights.py``).

The detector is the keypoint R-CNN cut to one block a stage at production
widths, at the photos' own 320 x 320 (so both letterboxes are exact), with
detection threshold 0 (random weights rarely score above 0.9). Checked: the
same kept photos written under the same names (the exclusion lists, the
``.jpg`` / ``.png`` suffixes, the animal types); each crop before encoding
within 1e-3 (on [0, 1]) of JAX's ``warp_perspective`` of the same map, and
within 8 levels (mean below 0.5) of the JAX pipeline's
``cv2.warpPerspective`` crop of the same photo (cv2 snaps samples to 1/32
px, ``test_torch_port_tsv_chain.py``); each written file holding exactly its
crop as PIL would save it (PNG lossless, JPEG quality 75); a second run
writes nothing.
"""

import importlib
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.ops.homography import warp_perspective as j_warp_perspective
from pets_face_recognition_tpu.preprocessor import Preproc3 as JPreproc3
from pets_face_recognition_tpu_torch import native, smoke_data, transform_reproduce, weights
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.ops.homography import alignment_homographies
from pets_face_recognition_tpu_torch.preprocessor import DEFAULT_BASE_PTS, Preproc3

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
j_transform = importlib.import_module("transform_reproduce")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
PRE, POST = 32, 8
SERVE = 8
OUTPUTS = ("data_25_transformed_v6_dogs", "data_25_transformed_v6_cats",
           "petfinder_extra_dogs_transformed_v6", "petfinder_extra_cats_transformed_v6")


class Recording:
    """A preprocessor that keeps each ``batch`` call's inputs and results."""

    def __init__(self, pre):
        self.pre, self.calls = pre, []
        self.serve_batch = pre.serve_batch

    def batch(self, images):
        out = self.pre.batch(images)
        self.calls.append((images, out))
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("transform")
    smoke_data.make_data25(root / "jax")
    smoke_data.make_petfinder_extras(root / "jax")
    shutil.copytree(root / "jax", root / "port")

    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    variables = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 320, 320, 3))), np.random.RandomState(21))
    det_fn = jax.jit(lambda x: j_det.apply(variables, x))
    det = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                    rpn_post_nms_top_n_test=POST)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(variables)),
                        strict=True)

    j_transform.DATA_ROOT = root / "jax"
    jpre = Recording(JPreproc3(model_fn=det_fn, thr=0.0, base_pts=j_transform.BASE_PTS,
                               dsize=(224, 224, 3), serve_batch=SERVE))
    j_transform.extra_petfinder(jpre, "dog")
    j_transform.data_25(jpre, 1)
    j_transform.data_25(jpre, 2)
    j_transform.extra_petfinder(jpre, "cat")

    pre = Recording(Preproc3(det.eval(), thr=0.0, base_pts=transform_reproduce.BASE_PTS,
                             dsize=(224, 224, 3), serve_batch=SERVE, device="cpu"))
    written = transform_reproduce.aligned(pre, data_root=root / "port")
    again = transform_reproduce.aligned(pre, data_root=root / "port")
    return dict(root=root, pre=pre, jpre=jpre, written=written, again=again)


def kept_crops(pre: Recording):
    """``(photo, crop)`` of every kept photo, in the order written."""
    return [(images[i], crops[i]) for images, (crops, valid, _) in pre.calls
            for i in np.nonzero(valid)[0]]


def _outputs(base: Path) -> list[str]:
    return sorted(str(p.relative_to(base)) for d in OUTPUTS for p in (base / d).rglob("*")
                  if p.is_file())


def test_same_kept_files_and_names(runs):
    """The same crops under the same relative names (none of the excluded
    photos, ``.png`` for the extras, ``.jpg`` for data_25), as the JAX
    script; a second run skips every existing output."""
    root = runs["root"]
    got, want = _outputs(root / "port"), _outputs(root / "jax")
    assert got == want and len(got) >= 30
    assert sorted(str(p.relative_to(root / "port")) for p in runs["written"]) == got
    assert not any("216319" in p or "660074" in p or "/3.png" in p or "24355557/4" in p
                   or "48683845" in p or "45528036" in p for p in got)
    assert runs["again"] == []


def test_crops_before_encoding_match_the_jax_warp(runs):
    """Each kept crop within 1e-3 on [0, 1] of JAX ``warp_perspective`` of
    the same homography (the rounded landmarks' map), as the serving
    slice's crops."""
    n = 0
    for images, (crops, valid, raw) in runs["pre"].calls:
        Hs = alignment_homographies(torch.from_numpy(raw["keypoints"]),
                                    torch.from_numpy(DEFAULT_BASE_PTS))
        for i in np.nonzero(valid)[0]:
            want = np.asarray(j_warp_perspective(jnp.asarray(images[i], jnp.float32),
                                                 jnp.asarray(Hs[i].numpy()), (224, 224)))
            got = crops[i].numpy()
            finite = np.isfinite(want)
            assert np.array_equal(finite, np.isfinite(got))
            assert np.abs(got[finite] - want[finite]).max() / 255.0 <= 1e-3
            n += 1
    assert n >= 30


def test_crops_match_the_jax_pipeline(runs):
    """Each kept crop against the JAX pipeline's crop of the same photo, as
    both write them (clipped, truncated to uint8): within 8 levels, mean
    below 0.5."""
    jax_crops = kept_crops(runs["jpre"])
    port = kept_crops(runs["pre"])
    assert len(port) == len(jax_crops)
    for photo, crop in port:
        want = [c for p, c in jax_crops if np.array_equal(p, photo)]
        assert len(want) == 1
        got = np.clip(np.nan_to_num(crop.numpy()), 0, 255).astype(np.uint8).astype(int)
        diff = np.abs(got - np.clip(want[0], 0, 255).astype(np.uint8))
        assert diff.max() <= 8 and diff.mean() < 0.5, (diff.max(), diff.mean())


def test_written_files_hold_their_crops(runs, tmp_path):
    """Each file decodes to its crop as PIL saves it: a PNG to the uint8
    crop itself, a JPEG to PIL's default (quality 75) save of it; and the
    files decode within a mean of 0.5 levels of the JAX script's."""
    root = runs["root"]
    port = kept_crops(runs["pre"])
    for path, (_, crop) in zip(runs["written"], port):
        img = np.clip(np.nan_to_num(crop.numpy()), 0, 255).astype(np.uint8)
        got = native.read_rgb(path)
        if path.suffix == ".png":
            assert np.array_equal(got, img), path
        else:
            Image.fromarray(img).save(tmp_path / "pil.jpg")
            assert np.array_equal(np.asarray(Image.open(path)),
                                  np.asarray(Image.open(tmp_path / "pil.jpg"))), path
        want = np.asarray(Image.open(root / "jax" / path.relative_to(root / "port")))
        assert np.abs(got.astype(int) - want).mean() < 0.5, path
