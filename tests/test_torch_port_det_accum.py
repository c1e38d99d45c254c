"""Gradient accumulation of the port's keypoint R-CNN step against the JAX
package's ``optax.MultiSteps`` (``wrap_gradient_transform(tx, clip, k)``) on
the CPU: k = 2 with global-norm clipping, four mini-steps on the same weights
(carried over by ``weights.py``), batches and sampler noise (the JAX keys
rebuilt as in ``test_torch_port_train.py``).

The schedule drops the rate x 0.1 at an update count of 1, so the second
update runs at the lower rate only if the schedule counts updates (as the
inner optax chain does) and not mini-steps. Sizes: trunk stages (1, 1, 1, 1)
at production widths, B = 2 images of 64 x 64, G = 2 boxes, RPN 32 / 16, 8
box samples an image.
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

from test_torch_port_models import randomize
from test_torch_port_train import jax_sampler_noise

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, G, K, CLIP, LR, MILESTONE = 2, 64, 2, 2, 0.5, 5e-2, 1
BUDGETS = dict(rpn_pre_nms_top_n_train=32, rpn_post_nms_top_n_train=16,
               box_batch_size_per_image=8)
N_STEPS = 4


@pytest.fixture(scope="module")
def run():
    batches = [synthetic_keypoint_batch(B, IMG, IMG, G, seed=40 + i) for i in range(N_STEPS)]
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            **BUDGETS)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    config = types.SimpleNamespace(
        model=lambda: j_det, loss=lambda c, m: SumDetectionLoss(model=m),
        optimizer=lambda c: j_detection_sgd_optimizer(LR, milestones_steps=[MILESTONE]))
    ctl = JKeyPointsController(config)
    targets = ctl._targets_from_batch(batches[0])
    shapes = jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        jnp.asarray(batches[0]["images"]), targets, train=True))
    variables = randomize(shapes, np.random.RandomState(23))
    tx = wrap_gradient_transform(config.optimizer(config), CLIP, K)
    j_state = JTrainState.create(ctl.model_loss.apply, jax.tree.map(jnp.array, variables), tx)
    j_step = ctl.make_train_step()

    model = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, **BUDGETS)
    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})))
    t_ctl = KeyPointsController(
        optimizer_fn=lambda p: detection_sgd_optimizer(p, LR, milestones_steps=[MILESTONE]),
        gradient_clip_val=CLIP, accumulate_grad_batches=K)
    t_state = t_ctl.init_state(0, "cpu", model=model)
    anchors = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))

    def params_now():
        return {k: v.detach().clone().numpy() for k, v in model.named_parameters()}

    start = params_now()
    t_params, j_params, t_lrs = [], [], []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        noise = jax_sampler_noise(ctl.model_loss, {"params": j_state.params,
                                                   "batch_stats": j_state.batch_stats},
                                  key, B, anchors, BUDGETS["rpn_post_nms_top_n_train"] + G)
        j_state, _ = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        t_ctl.train_step(t_state, batch, sampler_noise={k: torch.from_numpy(v)
                                                         for k, v in noise.items()})
        t_params.append(params_now())
        t_lrs.append(t_state.optimizer.param_groups[0]["lr"])
        j_params.append(weights.detection_state_dict({"params": j_state.params["model"]}))
    return dict(start=start, t_params=t_params, j_params=j_params, t_lrs=t_lrs,
                t_state=t_state, j_state=j_state)


def test_params_do_not_move_between_updates(run):
    """Mini-steps 1 and 3 change no parameter, in either framework; the
    partial mean is held in the state until the update."""
    for i in (0, 2):
        before = run["start"] if i == 0 else run["t_params"][i - 1]
        for k, v in run["t_params"][i].items():
            np.testing.assert_array_equal(v, before[k], err_msg=f"{k} mini-step {i + 1}")
            np.testing.assert_array_equal(np.asarray(run["j_params"][i][k]), before[k]
                                          if i == 0 else np.asarray(run["j_params"][i - 1][k]))


@pytest.mark.parametrize("mini_step", [2, 4])
def test_params_after_each_update_match_multisteps(run, mini_step):
    """After mini-steps 2 and 4 (the two updates) every parameter within
    1e-5 absolute of ``optax.MultiSteps`` around clip -> decay -> SGD; each
    update moved the parameters."""
    t, j = run["t_params"][mini_step - 1], run["j_params"][mini_step - 1]
    prev = run["t_params"][mini_step - 2]
    moved = 0
    for k, v in t.items():
        np.testing.assert_allclose(v, np.asarray(j[k]), rtol=0, atol=1e-5, err_msg=k)
        moved += not np.array_equal(v, prev[k])
    assert moved > len(t) // 2


def test_schedule_counts_updates_not_mini_steps(run):
    """The rate of the first update is the base rate and of the second the
    rate after the milestone at update count 1 (at a mini-step count the
    first update would already run at the lower rate); the step counts
    mini-steps and no partial mean is left after an update."""
    assert run["t_lrs"][1] == LR and run["t_lrs"][3] == pytest.approx(LR * 0.1)
    assert run["t_state"].step == N_STEPS == int(run["j_state"].step)
    assert run["t_state"].accum is None
    inner = run["j_state"].opt_state
    assert int(inner.gradient_step) == 2 and int(inner.mini_step) == 0
