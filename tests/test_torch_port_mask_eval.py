"""Mask R-CNN evaluation in the port against the JAX package on the CPU: the
device paste ``ops.masks.paste_masks`` against JAX's ``paste_masks`` within
1e-6 (sub-pixel boxes, boxes partly or wholly outside the image, zero and
negative widths); ``mask_iou`` and ``detection_metrics(with_masks=True)``
equal to JAX's; and the ``DetectionController`` eval step (the detector in
eval mode, the masks pasted at the batch's size), ``run_eval_batch`` and
``evaluate`` on the same weights: the same detections and pasted masks, and
the metrics (AP 50/70/90, Mean/Median IoU, Masks Mean IoU) within 1e-6.

The detector: trunk stages (1, 1, 1, 1) at production widths, 3 detections,
RPN 64/32, B = 2 images of 128 x 128; the mask logits' 1 x 1 conv is scaled
by 10 so that the probabilities spread away from 0.5 (random full-width
masks sit at 0.5 +- 0.05, where float32 rounding of the two frameworks'
convolutions could cut a pixel either way). The ground truth is built from
JAX's own detections (shifted boxes, masks cut at 0.3) so that every metric
is away from its trivial value.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pets_face_recognition_tpu.engine import detection_metrics as j_metrics
from pets_face_recognition_tpu.engine.detector_controller import \
    DetectionController as JDetectionController
from pets_face_recognition_tpu.engine.train_state import TrainState as JTrainState
from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.ops import masks as j_masks
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.engine import detection_metrics as metrics
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.ops.masks import paste_masks

from test_torch_port_models import randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, D = 2, 128, 3
BUDGETS = dict(rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32)


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(0)
    H, W, S = 45, 67, 28
    boxes = np.concatenate([
        rng.uniform(-10, 70, (2, 6, 4)),
        np.tile(np.array([[10.2, 11.7, 10.6, 12.1], [30.0, 5.0, 30.0, 40.0],
                          [50.0, 20.0, 45.0, 15.0], [-30.0, -30.0, -2.0, -1.5],
                          [60.5, 40.5, 90.0, 70.0], [0.0, 0.0, 67.0, 45.0]]), (2, 1, 1))],
        axis=1).astype(np.float32)
    boxes[:, :6, 2:] = boxes[:, :6, :2] + np.abs(boxes[:, :6, 2:] - boxes[:, :6, :2])
    masks = rng.rand(2, 12, S, S).astype(np.float32)
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), (H, W)).numpy()
    want = np.stack([np.asarray(j_masks.paste_masks(jnp.asarray(masks[b]), jnp.asarray(boxes[b]),
                                                    (H, W))) for b in range(2)])
    assert got.shape == want.shape == (2, 12, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want > 0).any(axis=(2, 3)).sum() >= 8       # boxes inside paste something


def _random_dets(rng, n_img=6, H=40, W=50):
    preds, trues = [], []
    for i in range(n_img):
        n, g = rng.randint(0, 4), rng.randint(0 if i else 1, 3)
        xy = rng.uniform(0, 30, (n, 2))
        preds.append({"boxes": np.concatenate([xy, xy + rng.uniform(5, 20, (n, 2))], 1),
                      "labels": rng.randint(1, 3, n), "scores": np.sort(rng.rand(n))[::-1],
                      "masks": rng.rand(n, H, W).astype(np.float32)})
        xy = rng.uniform(0, 30, (g, 2))
        tm = (rng.rand(g, H, W) > 0.6).astype(np.float32)
        if i == 2 and g:
            tm[:] = 0.0                                  # an empty union: NaN, dropped
            preds[-1]["masks"][:] = 0.0
        trues.append({"boxes": np.concatenate([xy, xy + rng.uniform(5, 20, (g, 2))], 1),
                      "labels": rng.randint(1, 3, g), "masks": tm * rng.uniform(0.9, 1.1)})
    return preds, trues


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_mask_iou_and_metrics_match_jax(seed):
    preds, trues = _random_dets(np.random.RandomState(seed))
    assert metrics.mask_iou(preds, trues) == j_metrics.mask_iou(preds, trues)
    got = metrics.detection_metrics(preds, trues, with_masks=True)
    want = j_metrics.detection_metrics(preds, trues, with_masks=True)
    assert list(got) == list(want) and "Masks Mean IoU" in got
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12, atol=0)
    padded = {"valid": np.ones((1, 2), bool), "boxes": np.zeros((1, 2, 4)),
              "labels": np.zeros((1, 2)), "scores": np.zeros((1, 2)),
              "masks": np.arange(2 * 6, dtype=np.float32).reshape(1, 2, 2, 3)}
    for ours, theirs in ((metrics.unpad_detections, j_metrics.unpad_detections),
                         (metrics.unpad_targets, j_metrics.unpad_targets)):
        np.testing.assert_array_equal(ours(padded, 1)[0]["masks"], theirs(padded, 1)[0]["masks"])


@pytest.fixture(scope="module")
def evaluated():
    rng = np.random.RandomState(41)
    images = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=D, **BUDGETS)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    config = types.SimpleNamespace(model=lambda: j_det,
                                   loss=lambda c, m: SumDetectionLoss(model=m))
    j_ctl = JDetectionController(config)
    variables = randomize(jax.eval_shape(lambda: j_ctl.model_loss.init(
        jax.random.PRNGKey(0), jnp.asarray(images))), rng)
    logits = variables["params"]["model"]["mask_head"]["mask_fcn_logits"]
    logits["kernel"], logits["bias"] = logits["kernel"] * 10, logits["bias"] * 10
    j_state = JTrainState.create(j_ctl.model_loss.apply, jax.tree.map(jnp.array, variables),
                                 optax.sgd(1e-3))
    j_eval = j_ctl.make_eval_step()
    dets = jax.device_get(j_eval(j_state, jnp.asarray(images)))

    # ground truth from JAX's detections: boxes moved by 2 px, masks cut at 0.3
    G = D
    batch = {"images": images, "boxes": np.zeros((B, G, 4), np.float32),
             "labels": np.zeros((B, G), np.int32), "valid": np.zeros((B, G), bool),
             "masks": np.zeros((B, G, IMG, IMG), np.float32)}
    for b in range(B):
        for g in np.flatnonzero(dets["valid"][b])[:G - b]:
            batch["boxes"][b, g] = dets["boxes"][b, g] + np.float32(2.0)
            batch["labels"][b, g] = dets["labels"][b, g] - 1
            batch["masks"][b, g] = (dets["masks"][b, g] >= 0.3).astype(np.float32)
            batch["valid"][b, g] = True
    assert batch["valid"].sum() >= 2
    j_out = j_ctl.run_eval_batch(j_eval, j_state, batch, None)
    j_metrics_out = j_ctl.evaluate([[j_out]])

    model = maskrcnn_resnet50_fpn(stage_sizes=STAGES, **BUDGETS)
    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})), strict=True)
    ctl = DetectionController()
    state = ctl.init_state(0, "cpu", model=model)
    out = ctl.run_eval_batch(ctl.make_eval_step(), state, batch)
    return dict(j_out=j_out, j_metrics=j_metrics_out, out=out, metrics=ctl.evaluate([[out]]),
                training=model.training)


def test_eval_step_matches_jax(evaluated):
    """Validity, labels equal; on valid slots boxes within 1e-4 of the side,
    scores 1e-5 and the pasted (B, D, H, W) masks 5e-4; no pasted pixel
    falls on the other side of 0.5; the targets equal. Random weights make
    thin boxes (0.66 px high here): the mask's sample rows move by 28 / 0.66
    cells a pixel of box, so the boxes' 9e-5 px of float32 rounding move
    the pasted values by up to 1.4e-4."""
    got, want = evaluated["out"], evaluated["j_out"]
    pg, pw = got["pred"], {k: np.asarray(v) for k, v in want["pred"].items()}
    assert sorted(pg) == sorted(pw) and pg["masks"].shape == (B, D, IMG, IMG)
    np.testing.assert_array_equal(pg["valid"], pw["valid"])
    v = pw["valid"]
    assert v.sum() >= 3
    np.testing.assert_array_equal(pg["labels"][v], pw["labels"][v])
    np.testing.assert_allclose(pg["boxes"][v], pw["boxes"][v], rtol=0, atol=1e-4 * IMG)
    np.testing.assert_allclose(pg["scores"][v], pw["scores"][v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(pg["masks"][v], pw["masks"][v], rtol=0, atol=5e-4)
    assert np.array_equal(pg["masks"][v] >= 0.5, pw["masks"][v] >= 0.5)
    for k in want["true"]:
        np.testing.assert_array_equal(got["true"][k], want["true"][k])
    assert got["batch_size"] == want["batch_size"] == B
    assert evaluated["training"]            # the eval step puts the model back in train()


def test_evaluate_matches_jax(evaluated):
    got, want = evaluated["metrics"]["val"], evaluated["j_metrics"]["val"]
    assert list(got) == list(want) == ["Mean IoU", "Median IoU", "AP 50", "AP 70", "AP 90",
                                       "Masks Mean IoU"]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0, atol=1e-6)
    assert got["AP 50"] > 0 and 0 < got["Masks Mean IoU"] < 1
