"""The port's int8 detectors against the JAX package on the CPU, as
``test_torch_port_quant_models.py`` holds the trunk and the embedder: the
keypoint R-CNN at ``quant_scope`` ``rpn`` (the shipping scope) and ``full``
with ``quant_kp``, ``quant_kp`` alone, and Mask R-CNN with ``quant``. Same
gates: the calibrate forward bit-equal to the float one,
scales within 1e-5, ``weight_q`` and ``w_scale`` exact, the int8 outputs on
JAX's carried state within JAX's own spread under input rounding plus 1e-4
(the float detectors' tolerance), and the activation flips counted.

JAX post-processes Mask R-CNN's detections on the CPU by its vmapped path,
whose padding slots repeat candidate 0 (ROADMAP note 17): the outputs are
compared on the valid slots, whose set must be the same.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import quant, rcnn

from test_torch_port_models import randomize
from test_torch_port_quant_models import (B, FLOAT_RTOL, IMG, STAGES, batches_and_input,
                                          check_flips, check_keypoint_rcnn, check_outputs,
                                          check_state, jax_activations, run_jax, run_port)

torch.set_num_threads(1)


@pytest.mark.parametrize("scope,detector,kp", [("rpn", True, True), ("full", True, True),
                                               ("rpn", False, True)],
                         ids=["rpn+kp", "full+kp", "kp_only"])
def test_keypoint_rcnn_int8_matches_jax(monkeypatch, scope, detector, kp):
    check_keypoint_rcnn(monkeypatch, scope, detector, kp)


def test_mask_rcnn_int8_matches_jax(monkeypatch):
    monkeypatch.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
    budgets = dict(rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32)
    D = 3

    def build(q=None):
        cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=D,
                                **budgets)
        body = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True,
                               quant=q)
        return j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=body), cfg=cfg,
                                      quant=q)

    batches, x = batches_and_input(80, (B, IMG, IMG, 3))
    rng = np.random.RandomState(81)
    variables = randomize(jax.eval_shape(build().init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    jq_state, want, inter, rounded = run_jax(build, variables, batches, x)
    sd = weights.to_tensors(weights.detection_state_dict(variables))
    float_t = rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, **budgets)
    float_t.load_state_dict(sd)
    model = quant.load_float_state_dict(
        rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, quant="calibrate", **budgets), sd)
    state, got, acts = run_port(model.eval(), float_t.eval(), batches, x, jq_state, "detection")
    check_state(state, jq_state, "detection")
    check_flips(acts, jax_activations(inter, "detection"))
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.any()
    np.testing.assert_array_equal(got["labels"][valid], want["labels"][valid])

    def pick(out):
        return {k: out[k][valid] for k in ("boxes", "scores", "masks")}

    check_outputs(pick(got), pick(want), [pick(r) for r in rounded], ("boxes", "scores", "masks"),
                  FLOAT_RTOL)
