"""Mask R-CNN training in the port against the JAX package on the CPU: the
mask targets (``project_masks_on_boxes``, boxes past the image's edges and
degenerate ones among them) and ``maskrcnn_loss`` within 1e-6, and one whole
training step against ``DetectionController.make_train_step`` on the same
weights (carried over by ``weights.py``), batch and sampler noise: every
loss term (``loss_mask`` included) within 1e-4, every gradient (the mask
head's included) within 1e-3 relative in norm, and every parameter after the
SGD step within 1e-5 (the worst gradient within 1e-3 of JAX's own float32
spread, where a trunk ReLU sits within rounding of 0).

Sizes: trunk stages (1, 1, 1, 1) at production widths (FPN 256, box head
1024, mask head 256), B = 2 images of 128 x 128 of uniform noise, G = 2
boxes each with an elliptic 0/1 mask, RPN budgets 64 pre-NMS / 32 post-NMS,
16 box samples an image (P = 4 mask positives an image). The JAX sampler
keys are rebuilt as ``_forward_train`` derives them.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.engine.detector_controller import \
    DetectionController as JDetectionController
from pets_face_recognition_tpu.engine.train_state import TrainState as JTrainState
from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import roi_heads as j_rh
from pets_face_recognition_tpu.utils.optim import (detection_sgd_optimizer as
                                                   j_detection_sgd_optimizer,
                                                   wrap_gradient_transform)
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.models import roi_heads as rh
from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

from test_torch_port_models import randomize
from test_torch_port_train import _rel, jax_sampler_noise

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, G = 2, 128, 2
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               box_batch_size_per_image=16)
LR = 5e-3
LOSS_TERMS = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
              "loss_mask")


def ellipse(h, w, box):
    yy, xx = np.mgrid[:h, :w]
    x1, y1, x2, y2 = box
    cx, cy, ax, ay = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
    return ((((xx + 0.5 - cx) / ax) ** 2 + ((yy + 0.5 - cy) / ay) ** 2) < 1).astype(np.float32)


def mask_batch(seed: int = 3) -> dict:
    rng = np.random.RandomState(seed)
    batch = {"images": rng.rand(B, IMG, IMG, 3).astype(np.float32),
             "boxes": np.zeros((B, G, 4), np.float32), "labels": np.zeros((B, G), np.int32),
             "valid": np.zeros((B, G), bool), "masks": np.zeros((B, G, IMG, IMG), np.float32)}
    for b in range(B):
        for g in range(1 + b % G):
            w, h = rng.uniform(0.2, 0.6, 2) * IMG
            x1, y1 = rng.uniform(0, IMG - w), rng.uniform(0, IMG - h)
            batch["boxes"][b, g] = (x1, y1, x1 + w, y1 + h)
            batch["masks"][b, g] = ellipse(IMG, IMG, batch["boxes"][b, g])
            batch["valid"][b, g] = True
    return batch


def test_project_masks_on_boxes_and_loss_match_jax():
    """Per image: 12 boxes (inside, past every edge, sub-pixel, zero and
    negative width) over 3 masks of 61 x 83; the targets within 1e-6 and the
    loss of random logits on them within 1e-6 relative."""
    rng = np.random.RandomState(5)
    H, W, K = 61, 83, 12
    gt = (rng.rand(2, 3, H, W) > 0.5).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 100, (2, 8, 4)),
                            np.tile(np.array([[10.0, 10.0, 10.4, 10.3], [30.0, 5.0, 30.0, 40.0],
                                              [50.0, 20.0, 45.0, 15.0], [-30.0, -30.0, -2.0, -1.5]]),
                                    (2, 1, 1))], axis=1).astype(np.float32)
    boxes[:, :8, 2:] = boxes[:, :8, :2] + np.abs(boxes[:, :8, 2:] - boxes[:, :8, :2])
    idx = rng.randint(0, 3, (2, K))
    got = rh.project_masks_on_boxes(torch.from_numpy(gt), torch.from_numpy(boxes),
                                    torch.from_numpy(idx), 28).numpy()
    want = np.stack([np.asarray(j_rh.project_masks_on_boxes(
        jnp.asarray(gt[b]), jnp.asarray(boxes[b]), jnp.asarray(idx[b]), 28)) for b in range(2)])
    assert got.shape == want.shape == (2, K, 28, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0 < (want > 0.5).mean() < 1

    logits = rng.randn(2 * K, 28, 28, 3).astype(np.float32) * 2
    cls = rng.randint(0, 3, 2 * K)
    for fg in ((rng.rand(2 * K) > 0.4), np.zeros(2 * K, bool)):
        got_l = float(rh.maskrcnn_loss(torch.from_numpy(logits), torch.from_numpy(cls),
                                       torch.from_numpy(want.reshape(-1, 28, 28)),
                                       torch.from_numpy(fg)))
        want_l = float(j_rh.maskrcnn_loss(jnp.asarray(logits), jnp.asarray(cls),
                                          jnp.asarray(want.reshape(-1, 28, 28)), jnp.asarray(fg)))
        assert abs(got_l - want_l) <= 1e-6 * max(abs(want_l), 1e-30), (got_l, want_l)


@pytest.fixture(scope="module")
def step():
    batch = mask_batch()
    cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=3, **BUDGETS)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    config = types.SimpleNamespace(
        model=lambda: j_det, loss=lambda c, m: SumDetectionLoss(model=m),
        optimizer=lambda c: j_detection_sgd_optimizer(LR))
    ctl = JDetectionController(config)
    targets = ctl._targets_from_batch(batch)
    images = jnp.asarray(batch["images"])
    shapes = jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images,
        targets, train=True))
    variables = randomize(shapes, np.random.RandomState(23))
    key = jax.random.PRNGKey(9)

    def grad_fn(params, x):
        def loss_at(p):
            out = ctl.model_loss.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                       x, targets, train=True, rngs={"sampler": key})
            return out["loss"], out
        return jax.value_and_grad(loss_at, has_aux=True)(params)

    grad_fn = jax.jit(grad_fn)
    (_, j_out), j_grads = grad_fn(variables["params"], images)
    # JAX against itself: the same step on images changed by float32 rounding
    # (1e-7 relative), three draws
    j_spread = [weights.detection_state_dict({"params": grad_fn(variables["params"], images * (
        1 + jnp.asarray(np.random.RandomState(s).randn(*images.shape), jnp.float32) * 1e-7)
    )[1]["model"]}) for s in (1, 2, 3)]
    anchors = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = jax_sampler_noise(ctl.model_loss, variables, key, B, anchors,
                              BUDGETS["rpn_post_nms_top_n_train"] + G)

    model = maskrcnn_resnet50_fpn(stage_sizes=STAGES, **BUDGETS)
    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})))
    t_ctl = DetectionController(optimizer_fn=lambda p: detection_sgd_optimizer(p, LR))
    t_state = t_ctl.init_state(0, "cpu", model=model)
    t_out = t_ctl.train_step(t_state, batch, sampler_noise={k: torch.from_numpy(v)
                                                             for k, v in noise.items()})

    tx = wrap_gradient_transform(config.optimizer(config))
    j_state = JTrainState.create(ctl.model_loss.apply, jax.tree.map(jnp.array, variables), tx)
    j_new, j_metrics = ctl.make_train_step()(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return dict(model=model, t_out=t_out, j_out=j_out, j_metrics=j_metrics,
                j_grads=weights.detection_state_dict({"params": j_grads["model"]}),
                j_spread=j_spread, j_params=weights.detection_state_dict({"params": j_new.params["model"]}))


@pytest.mark.parametrize("term", ("loss",) + LOSS_TERMS)
def test_mask_train_step_losses_match_jax(step, term):
    """Each loss term and their sum, against the JAX forward and the metrics
    of ``make_train_step``: 1e-4 relative."""
    got = step["t_out"][term]
    for want in (float(step["j_out"][term]), float(step["j_metrics"][term])):
        assert abs(got - want) <= 1e-4 * abs(want), (term, got, want)


def test_mask_train_step_gradients_match_jax(step):
    """Every parameter's gradient within 1e-3 relative in norm: the mask
    head's (nonzero; the background class's rows of the mask logits get
    none, in both) and the median tensor always; the worst tensor within
    1e-3 more than the largest move of JAX's own gradients when its input
    images are rounded differently (1e-7 relative, three draws). One ReLU
    of the trunk's first block sits within rounding of 0 on these weights:
    one of JAX's three draws flips it and moves the stem's and first
    block's gradients by 1.4919e-3 (``layer1.0.bn1.weight``), and the port,
    whose convolutions sum in another order, lands on the other side of it:
    1.4925e-3. A wrong gradient is off by far more."""
    grads = {n: p.grad for n, p in step["model"].named_parameters()}
    assert sorted(grads) == sorted(step["j_grads"])
    head = [n for n in grads if ".mask_" in n]
    assert len(head) == 12 and all(float(grads[n].norm()) > 0 for n in head)
    logits_w = "roi_heads.mask_predictor.mask_fcn_logits.weight"
    assert float(grads[logits_w][0].abs().max()) == 0.0
    assert np.abs(step["j_grads"][logits_w][0]).max() == 0.0
    errs = {n: _rel(grads[n], step["j_grads"][n]) for n in grads}
    assert max(errs[n] for n in head) <= 1e-3
    assert np.median(list(errs.values())) <= 1e-3
    spread = max(_rel(d[n], step["j_grads"][n]) for d in step["j_spread"] for n in grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3 + spread, (worst, errs[worst], spread)


def test_mask_train_step_updated_parameters_match_jax(step):
    """Every parameter after the SGD step: 1e-5 relative in norm."""
    params = dict(step["model"].named_parameters())
    errs = {n: _rel(params[n].detach(), step["j_params"][n]) for n in params}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
