"""The port's keypoint R-CNN eval step and ``evaluate`` against the JAX
package's ``KeyPointsController.make_eval_step`` / ``run_eval_batch`` /
``evaluate`` on the CPU, on weights carried over by ``weights.py`` and the
validation photos of the committed CAT miniature (read and collated by the
port's data path).

ResNet-50-FPN with trunk stages (1, 1, 1, 1) at production widths, B = 4 at
128 x 128, RPN 64 / 16 in eval; JAX pools these RoIs through its exact
gather. The MobileNetV3 detector is in ``test_torch_port_det_eval_mobile.py``
with the same checks.
"""

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.engine.detector_controller import \
    KeyPointsController as JKeyPointsController
from pets_face_recognition_tpu.engine.logging import MetricsLogger as JMetricsLogger
from pets_face_recognition_tpu.engine.train_state import TrainState as JTrainState
from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils.optim import detection_sgd_optimizer as j_sgd
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
from pets_face_recognition_tpu_torch.models.rcnn import (frozen_twin, keypointrcnn_resnet50_fpn,
                                                         mobile_net_v3_large_keypoint_rcnn)

from test_torch_port_models import randomize

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch" / "testdata"
EVAL_BUDGETS = dict(rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16)
# batch, image, (score rtol, atol), (box and keypoint rtol, atol), and the
# metric dict's tolerance (absolute; relative for the pixel errors MAE, MSE)
RESNET = dict(B=4, image=128, scores=(1e-4, 1e-5), boxes=(1e-4, 1e-4), metrics=1e-4)


def _val_batch(tmp_path_factory, B, image):
    config = build_keypoint_config(data_root=str(TESTDATA), test_batch_size=B,
                                   image_size=(image, image), num_workers=0,
                                   output=str(tmp_path_factory.mktemp("out")))
    return next(iter(config["val_dataloader"]()))


def eval_case(arch, case, tmp_path_factory):
    """The same val batch through the JAX controller's and the port's eval
    step, on the same random weights."""
    batch = _val_batch(tmp_path_factory, case["B"], case["image"])
    if arch == "resnet50":
        j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
            stage_sizes=(1, 1, 1, 1), features_only=True, frozen_stats=True)),
            cfg=j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                                  **EVAL_BUDGETS))
        model = keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1), **EVAL_BUDGETS)
    else:
        j_det = j_rcnn.mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9,
                                                         **EVAL_BUDGETS)
        model = mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.9,
                                                  **EVAL_BUDGETS)
    config = types.SimpleNamespace(model=lambda: j_det,
                                   loss=lambda c, m: SumDetectionLoss(model=m),
                                   optimizer=lambda c: j_sgd(5e-3))
    j_ctl = JKeyPointsController(config)
    variables = randomize(jax.eval_shape(lambda: j_ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        jnp.asarray(batch["images"]), j_ctl._targets_from_batch(batch), train=True)),
        np.random.RandomState(31))
    j_state = JTrainState.create(j_ctl.model_loss.apply, variables, config.optimizer(config))
    j_out = j_ctl.run_eval_batch(j_ctl.make_eval_step(), j_state, batch, None)

    model.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {k: v["model"] for k, v in variables.items()})), strict=True)
    ctl = KeyPointsController(model_fn=lambda: model)
    state = ctl.init_state(0, "cpu", model=model)
    out = ctl.run_eval_batch(ctl.make_eval_step(), state, batch)
    return dict(arch=arch, case=case, batch=batch, j_ctl=j_ctl, j_out=j_out, ctl=ctl,
                state=state, out=out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return eval_case("resnet50", RESNET, tmp_path_factory)


def test_eval_step_matches_jax(run):
    """The detections on the host: valid and labels equal, scores, boxes and
    keypoints within the case's tolerance; the targets carry the +1 label."""
    got, want = run["out"]["pred"], run["j_out"]["pred"]
    case = run["case"]
    (s_rtol, s_atol), (b_rtol, b_atol) = case["scores"], case["boxes"]
    assert run["out"]["batch_size"] == run["j_out"]["batch_size"] == case["B"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert isinstance(got[k], np.ndarray) and got[k].shape == np.shape(want[k]), k
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=s_rtol,
                               atol=s_atol)
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]), rtol=b_rtol,
                               atol=b_atol)
    np.testing.assert_allclose(got["keypoints"][..., :2],
                               np.asarray(want["keypoints"])[..., :2], rtol=b_rtol, atol=b_atol)
    for k, v in run["out"]["true"].items():
        np.testing.assert_array_equal(v, run["j_out"]["true"][k])
    assert (run["out"]["true"]["labels"][run["out"]["true"]["valid"]] == 1).all()


def test_evaluate_matches_jax(run, tmp_path):
    """``evaluate`` on the two sides' outputs: the same metric names in the
    same order, logged under the same keys (``<prefix><split> <metric>``),
    and values within the case's tolerance."""
    tol = run["case"]["metrics"]
    logger, j_logger = MetricsLogger(tmp_path / "port"), JMetricsLogger(tmp_path / "jax")
    got = run["ctl"].evaluate([[run["out"]]], logger=logger, epoch=3, prefix="val ")
    want = run["j_ctl"].evaluate([[run["j_out"]]], logger=j_logger, epoch=3, prefix="val ")
    assert list(got) == list(want) == ["val"]
    assert list(got["val"]) == list(want["val"])
    assert {"AP 50", "AP 70", "Mean IoU", "NME"} <= set(got["val"])
    for k, v in got["val"].items():
        scale = abs(want["val"][k]) if k in ("MAE", "MSE") else 1.0
        assert abs(v - want["val"][k]) <= tol * scale, (k, v, want["val"][k])
    records = [json.loads((tmp_path / side / "metrics.jsonl").read_text())
               for side in ("port", "jax")]
    assert list(records[0]) == list(records[1]) and records[0]["step"] == 3


def test_eval_step_pools_with_running_statistics_and_restores_train_mode(run):
    """The eval step leaves the model in ``train()``, moves no running
    statistic and gives the frozen twin's detections: a live-BN trunk
    normalises with its running statistics in eval."""
    state, batch = run["state"], run["batch"]
    before = {n: b.clone() for n, b in state.model.named_buffers()}
    again = run["ctl"].make_eval_step()(state, torch.from_numpy(batch["images"]))
    assert state.model.training
    for n, b in state.model.named_buffers():
        assert torch.equal(b, before[n]), n
    np.testing.assert_array_equal(again["scores"].numpy(), run["out"]["pred"]["scores"])
    if run["arch"] == "mobile":
        with torch.no_grad():
            twin = frozen_twin(state.model)(torch.from_numpy(batch["images"]))
        np.testing.assert_array_equal(twin["scores"].numpy(), run["out"]["pred"]["scores"])
        np.testing.assert_array_equal(twin["boxes"].numpy(), run["out"]["pred"]["boxes"])
