"""One whole keypoint R-CNN training step of the port against the JAX
package's ``KeyPointsController.make_train_step`` on the CPU, on the same
weights (carried over by ``pets_face_recognition_tpu_torch.weights``), the
same batch and the same sampler noise: the five loss terms and their sum, the
gradient of every parameter, and every parameter after the SGD step.

Sizes: trunk stages (1, 1, 1, 1) at production widths (FPN 256, box head
1024, keypoint head 512), B = 2 images of 128 x 128, G = 2 boxes each, RPN
budgets 64 pre-NMS / 32 post-NMS, 16 box samples per image (so the keypoint
head sees P = 4 positives per image). The JAX sampler keys are rebuilt as
``_forward_train`` derives them: the model's ``make_rng("sampler")``, split
into RPN and box keys, each split over the images, then ``uniform`` per image.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.engine.detector_controller import \
    KeyPointsController as JKeyPointsController
from pets_face_recognition_tpu.engine.train_state import TrainState as JTrainState
from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils.optim import (detection_sgd_optimizer as
                                                   j_detection_sgd_optimizer,
                                                   wrap_gradient_transform)
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

from test_torch_port_models import ZERO_BY_CONSTRUCTION, jax_sampler_noise, randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, G = 2, 128, 2
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               box_batch_size_per_image=16)
LR = 5e-3
LOSS_TERMS = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
              "loss_keypoint")


@pytest.fixture(scope="module")
def step():
    batch = synthetic_keypoint_batch(B, IMG, IMG, G, seed=3)
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            **BUDGETS)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    config = types.SimpleNamespace(
        model=lambda: j_det, loss=lambda c, m: SumDetectionLoss(model=m),
        optimizer=lambda c: j_detection_sgd_optimizer(LR))
    ctl = JKeyPointsController(config)
    targets = ctl._targets_from_batch(batch)
    images = jnp.asarray(batch["images"])
    shapes = jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images,
        targets, train=True))
    variables = randomize(shapes, np.random.RandomState(21))
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        out = ctl.model_loss.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   images, targets, train=True, rngs={"sampler": key})
        return out["loss"], out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    anchors = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = jax_sampler_noise(ctl.model_loss, variables, key, B, anchors,
                              BUDGETS["rpn_post_nms_top_n_train"] + G)

    model = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **BUDGETS)
    # SumDetectionLoss holds the detector under "model"
    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})))
    t_ctl = KeyPointsController(optimizer_fn=lambda p: detection_sgd_optimizer(p, LR))
    t_state = t_ctl.init_state(0, "cpu", model=model)
    t_out = t_ctl.train_step(t_state, batch, sampler_noise={k: torch.from_numpy(v)
                                                             for k, v in noise.items()})

    tx = wrap_gradient_transform(config.optimizer(config))
    j_state = JTrainState.create(ctl.model_loss.apply, jax.tree.map(jnp.array, variables), tx)
    j_new, j_metrics = ctl.make_train_step()(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return dict(model=model, t_out=t_out, j_out=j_out, j_metrics=j_metrics,
                j_leaves=len(jax.tree_util.tree_leaves(j_grads["model"])),
                j_grads=weights.detection_state_dict({"params": j_grads["model"]}),
                j_params=weights.detection_state_dict({"params": j_new.params["model"]}))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("term", ("loss",) + LOSS_TERMS)
def test_train_step_losses_match_jax(step, term):
    """Each loss term and their sum, against the JAX forward and against the
    metrics of ``make_train_step``: 1e-4 relative (the float32 convolution
    chain sums in another order in the two frameworks)."""
    got = step["t_out"][term]
    for want in (float(step["j_out"][term]), float(step["j_metrics"][term])):
        assert abs(got - want) <= 1e-4 * abs(want), (term, got, want)


def test_train_step_gradients_match_jax(step):
    """Every parameter's gradient: 1e-3 relative in norm. The chain of float32
    convolutions forward and backward sums in another order in the two
    frameworks, and RoIAlign's backward scatter-adds where JAX differentiates
    a separable matmul form."""
    grads = {n: p.grad for n, p in step["model"].named_parameters()}
    assert sorted(grads) == sorted(step["j_grads"])
    for n in ZERO_BY_CONSTRUCTION:
        assert np.abs(grads.pop(n).numpy()).max() <= 1e-6
        assert np.abs(step["j_grads"][n]).max() <= 1e-6
    errs = {n: _rel(grads[n], step["j_grads"][n]) for n in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_train_step_updated_parameters_match_jax(step):
    """Every parameter after the SGD step (weight decay, momentum, lr 5e-3):
    1e-5 relative in norm."""
    params = dict(step["model"].named_parameters())
    errs = {n: _rel(params[n].detach(), step["j_params"][n]) for n in params}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])


def test_trainable_parameters_are_the_jax_params_leaves(step):
    """The port trains exactly the JAX ``params`` leaves: the same count, and
    by the bridge's names the same shapes (the trunk's BN affine included, the
    running statistics excluded)."""
    params = dict(step["model"].named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert len(params) == step["j_leaves"]
    for n, p in params.items():
        assert tuple(p.shape) == step["j_grads"][n].shape, n
    buffers = dict(step["model"].named_buffers())
    assert buffers and all(n.endswith(("running_mean", "running_var")) for n in buffers)

