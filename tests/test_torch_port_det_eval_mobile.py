"""The eval step and ``evaluate`` of the keypoint config's MobileNetV3
detector (live BatchNorm, pooling with its running statistics in eval)
against the JAX package's, with the checks of ``test_torch_port_det_eval.py``,
at both of JAX's eval RoIAlign routes:

- ``gather``: B = 2 at 128 x 128 with JAX's dense limit set to 0, its exact
  float32 gather; held as the ResNet detector is;
- ``dense_bf16``: B = 1 at 320 x 320, JAX's default route there, its dense
  einsum in bfloat16 (ROADMAP §3 note 8). The port pools in float32, so the
  scores, boxes and keypoints are held to bfloat16's rounding, 2^-8
  relative; the top score measured 4.9e-4 relative apart on this input.
"""

import pytest

from pets_face_recognition_tpu.models import rcnn as j_rcnn

from test_torch_port_det_eval import eval_case
from test_torch_port_det_eval import test_eval_step_matches_jax as check_detections
from test_torch_port_det_eval import test_evaluate_matches_jax as check_evaluate
from test_torch_port_det_eval import \
    test_eval_step_pools_with_running_statistics_and_restores_train_mode as check_eval_mode

BF16 = 2.0 ** -8
ROUTES = {"gather": (0, dict(B=2, image=128, scores=(1e-4, 1e-5), boxes=(1e-4, 1e-3),
                             metrics=1e-4)),
          "dense_bf16": (None, dict(B=1, image=320, scores=(BF16, 1e-5), boxes=(BF16, 1e-3),
                                    metrics=BF16))}


@pytest.fixture(scope="module", params=list(ROUTES))
def run(request, tmp_path_factory):
    dense_limit, case = ROUTES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if dense_limit is not None:
            mp.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", dense_limit)
        return eval_case("mobile", case, tmp_path_factory)


def test_mobile_eval_step_matches_jax(run):
    check_detections(run)


def test_mobile_evaluate_matches_jax(run, tmp_path):
    check_evaluate(run, tmp_path)


def test_mobile_eval_step_pools_with_running_statistics(run):
    check_eval_mode(run)
