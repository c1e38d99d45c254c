"""One live-BatchNorm training step of the port's MobileNetV3 keypoint R-CNN
against the JAX package's ``KeyPointsController.make_train_step`` on the CPU
(the keypoint config's ``arch="mobile"`` model: ``frozen_stats=False,
bn_momentum=0.9``), on the same weights, batch and sampler noise: the loss
terms, every gradient, every parameter after the SGD step and every running
statistic after the step; then the frozen serving twin built from the trained
state against the JAX frozen model on the JAX step's new variables.

Sizes: the full MobileNetV3 trunk and production head widths, B = 2 images of
128 x 128, G = 2 boxes each, RPN budgets 64 pre-NMS / 32 post-NMS in training
and 64 / 16 in eval, 16 box samples an image. The pyramid is p4, p5 (pooled)
and p6, 15 anchors a location, so JAX pools the training RoIs by its
separable einsum and the port by the plain K3 and K4.
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
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.utils.optim import (detection_sgd_optimizer as
                                                   j_detection_sgd_optimizer,
                                                   wrap_gradient_transform)
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import (KeyPointsController,
                                                                         keypoint_model)
from pets_face_recognition_tpu_torch.models.rcnn import (frozen_twin,
                                                         mobile_net_v3_large_keypoint_rcnn)
from pets_face_recognition_tpu_torch.models.resnet import LiveBatchNorm2d, FrozenBatchNorm2d
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

from test_torch_port_models import randomize
from test_torch_port_train import ZERO_BY_CONSTRUCTION, jax_sampler_noise

torch.set_num_threads(1)

B, IMG, G = 2, 128, 2
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               box_batch_size_per_image=16, rpn_pre_nms_top_n_test=64,
               rpn_post_nms_top_n_test=16)
LR = 5e-3
# a per-channel shift of these outputs reaches only the inputs of live
# norms (through the residual adds up to block 10's expand conv; c2 and c3
# are not pooled), whose batch mean removes it: their gradients are 0 in
# exact arithmetic and only rounding is left on either side (~1e-6)
SHIFTS_REMOVED_BY_LIVE_BN = tuple(f"backbone.body.blocks.{i}.bn_project.bias"
                                  for i in range(10))
LOSS_TERMS = ("loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg", "loss_keypoint")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def step():
    batch = synthetic_keypoint_batch(B, IMG, IMG, G, seed=5)
    j_det = j_rcnn.mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9,
                                                     **BUDGETS)
    config = types.SimpleNamespace(
        model=lambda: j_det, loss=lambda c, m: SumDetectionLoss(model=m),
        optimizer=lambda c: j_detection_sgd_optimizer(LR))
    ctl = JKeyPointsController(config)
    targets = ctl._targets_from_batch(batch)
    images = jnp.asarray(batch["images"])
    shapes = jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images,
        targets, train=True))
    variables = randomize(shapes, np.random.RandomState(23))
    key = jax.random.PRNGKey(9)

    @jax.jit
    def grad_fn(params, x):
        def loss_fn(p):
            out, _ = ctl.model_loss.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                          x, targets, train=True, rngs={"sampler": key},
                                          mutable=["batch_stats"])
            return out["loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, j_out), j_grads = grad_fn(variables["params"], images)
    # JAX against itself: the same step on images changed by float32 rounding
    # (1e-7 relative), three draws
    j_spread = [weights.detection_state_dict({"params": grad_fn(variables["params"], images * (
        1 + jnp.asarray(np.random.RandomState(s).randn(*images.shape), jnp.float32) * 1e-7)
    )[1]["model"]}) for s in (1, 2, 3)]
    anchors = 15 * sum((IMG // s) ** 2 for s in (16, 32, 64))
    noise = jax_sampler_noise(ctl.model_loss, variables, key, B, anchors,
                              BUDGETS["rpn_post_nms_top_n_train"] + G)

    model = mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9, **BUDGETS)
    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})), strict=True)
    t_ctl = KeyPointsController(optimizer_fn=lambda p: detection_sgd_optimizer(p, LR))
    t_state = t_ctl.init_state(0, "cpu", model=model)
    before = {n: b.clone() for n, b in model.named_buffers()}
    t_out = t_ctl.train_step(t_state, batch, sampler_noise={k: torch.from_numpy(v)
                                                             for k, v in noise.items()})

    tx = wrap_gradient_transform(config.optimizer(config))
    j_state = JTrainState.create(ctl.model_loss.apply, jax.tree.map(jnp.array, variables), tx)
    j_new, j_metrics = ctl.make_train_step()(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    new_vars = {"params": j_new.params["model"], "batch_stats": j_new.batch_stats["model"]}
    return dict(model=model, state=t_state, ctl=t_ctl, t_out=t_out, j_out=j_out,
                j_metrics=j_metrics, before=before, batch=batch,
                j_grads=weights.detection_state_dict({"params": j_grads["model"]}),
                j_spread=j_spread,
                j_new=weights.detection_state_dict(new_vars), j_new_vars=new_vars)


@pytest.mark.parametrize("term", LOSS_TERMS)
def test_live_bn_step_losses_match_jax(step, term):
    """Each loss term and their sum, against the JAX forward and the metrics
    of ``make_train_step``: 1e-4 relative."""
    got = step["t_out"][term]
    for want in (float(step["j_out"][term]), float(step["j_metrics"][term])):
        assert abs(got - want) <= 1e-4 * abs(want), (term, got, want)


def test_live_bn_step_gradients_match_jax(step):
    """Every parameter's gradient, the live norms' affine included, held to
    JAX's own float32 spread: this step is ill-conditioned in float32 (live
    BatchNorm over 8 to 32 values a channel at the coarse levels, chained
    through 40 norms), so rounding the input images differently (1e-7
    relative) moves JAX's own gradients by ~1e-3 to ~1e-2 relative in norm
    (median over tensors 1.3e-3 to 7.3e-3, largest up to 1.2e-2, in three
    draws). The port must be no further from JAX than that: its worst and
    median tensor within 1e-3, or else within the middle draw's worst and
    median. The losses, the parameters after the step and the running
    statistics are held at fixed tolerances below. Gradients that are 0 by
    construction: at most 1e-5 on both sides. (The card-against-CPU gate of
    ``chip_smoke.py`` allows twice its spread, since both of its runs carry
    cuDNN's and the CPU's own rounding; here JAX's spread is measured
    against the very run the port is compared with.)"""
    grads = {n: p.grad.numpy() for n, p in step["model"].named_parameters()}
    assert sorted(grads) == sorted(step["j_grads"])
    for n in ZERO_BY_CONSTRUCTION + SHIFTS_REMOVED_BY_LIVE_BN:
        assert np.linalg.norm(grads.pop(n)) <= 1e-5, n
        assert np.linalg.norm(step["j_grads"][n]) <= 1e-5, n
    errs = {n: _rel(grads[n], step["j_grads"][n]) for n in grads}
    spreads = [[_rel(d[n], step["j_grads"][n]) for n in grads] for d in step["j_spread"]]
    worst_bound = max(1e-3, float(np.median([max(s) for s in spreads])))
    median_bound = max(1e-3, float(np.median([np.median(s) for s in spreads])))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= worst_bound, (worst, errs[worst], worst_bound)
    assert np.median(list(errs.values())) <= median_bound, median_bound


def test_live_bn_step_parameters_match_jax(step):
    """Every parameter after the SGD step (weight decay, momentum, lr 5e-3):
    1e-5 relative in norm once the step's own gradient difference is taken
    out. On the first step the update is ``-lr * (g + wd * p)`` on both
    sides, so ``p_port - p_jax = -lr * (g_port - g_jax)`` up to rounding; the
    gradients themselves are held above (unadjusted, the stem's weight is
    8e-5 apart)."""
    params = dict(step["model"].named_parameters())
    errs = {}
    for n, p in params.items():
        moved = p.detach().numpy() + LR * (p.grad.numpy() - step["j_grads"][n])
        errs[n] = _rel(moved, step["j_new"][n])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])


def test_live_bn_step_running_statistics_match_jax(step):
    """Every running mean and variance after the step against the JAX step's
    new ``batch_stats`` (one update at momentum 0.9 with the biased batch
    variance): 1e-5 relative in norm; and each of them moved."""
    buffers = dict(step["model"].named_buffers())
    assert sorted(buffers) == sorted(k for k in step["j_new"] if k.endswith(("running_mean",
                                                                             "running_var")))
    errs = {n: _rel(b, step["j_new"][n]) for n, b in buffers.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    assert all(not torch.equal(b, step["before"][n]) for n, b in buffers.items())


def test_frozen_twin_matches_the_jax_frozen_model(step, monkeypatch):
    """The serving twin of a trained live-BN state (``KeyPointsController.
    serving_model`` -> ``rcnn.frozen_twin``: frozen statistics, a strict
    load of the weights and running statistics, eval mode) against the JAX
    detector rebuilt with ``frozen_stats=True``, both on the JAX step's new
    variables (the port's own trained state differs from them by the step's
    ill-conditioned gradients, see above): top box, score and keypoints at
    1e-4; the twin's statistics do not move. JAX pools through its gather
    route here (the dense limit set to 0): its dense einsum route, which it
    takes at 128 x 128, rounds the level maps and weights to bfloat16 (the
    ``compute_dtype`` default of ``multilevel_roi_align_dense``, which its
    ``_roi_align`` does not pass), and is 1.3e-4 away in score on these
    inputs, where the gather route is 4e-7 away."""
    monkeypatch.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
    trained = mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9, **BUDGETS)
    trained.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        step["j_new_vars"])), strict=True)
    twin = step["ctl"].serving_model(step["ctl"].init_state(0, "cpu", model=trained))
    assert twin is not trained and trained.training
    assert not twin.training and not any(isinstance(m, LiveBatchNorm2d) for m in twin.modules())
    assert any(isinstance(m, FrozenBatchNorm2d) for m in twin.modules())
    j_frozen = j_rcnn.mobile_net_v3_large_keypoint_rcnn(frozen_stats=True, **BUDGETS)
    images = np.random.RandomState(6).rand(B, IMG, IMG, 3).astype(np.float32)
    want = jax.jit(lambda v, x: j_frozen.apply(v, x))(step["j_new_vars"], jnp.asarray(images))
    stats = {n: b.clone() for n, b in twin.named_buffers()}
    with torch.no_grad():
        got = twin(torch.from_numpy(images))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["keypoints"].numpy()[..., :2],
                               np.asarray(want["keypoints"])[..., :2], rtol=1e-4, atol=1e-3)
    assert all(torch.equal(b, stats[n]) for n, b in twin.named_buffers())


def test_keypoint_model_by_arch():
    """The keypoint config's models: ``mobile`` trains live BN at momentum
    0.9, ``resnet50`` a frozen trunk; another arch raises; ``frozen_twin``
    takes only a MobileNetV3 detector."""
    mobile = keypoint_model("mobile")
    norms = [m for m in mobile.backbone.body.modules() if isinstance(m, LiveBatchNorm2d)]
    assert norms and all(m.momentum == 0.9 and m.eps == 1e-3 for m in norms)
    assert mobile.num_anchors == 15
    assert not any(isinstance(m, LiveBatchNorm2d) for m in keypoint_model("resnet50").modules())
    with pytest.raises(ValueError, match="arch"):
        KeyPointsController(arch="swin")
    with pytest.raises(TypeError, match="MobileNetV3"):
        frozen_twin(keypoint_model("resnet50"))
