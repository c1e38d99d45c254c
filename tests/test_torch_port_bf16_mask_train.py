"""One whole Mask R-CNN training step computing in bfloat16 against the JAX
package's, on the CPU, as ``test_torch_port_bf16_train.py`` holds the
keypoint step: the JAX detector cloned to ``jnp.bfloat16`` as its training
bench builds it (``tools/bench_train.py:110-112``), the port's
``maskrcnn_resnet50_fpn(..., dtype=torch.bfloat16)``, the same weights,
batch (``test_torch_port_mask_train.mask_batch``), sampler noise and, carried
over its near-ties, JAX's training proposals; the loss terms, every gradient
and every parameter after SGD within twice JAX's own bfloat16 move, and a
planted fault (K4-bf16's gradients doubled) rejected.
"""

import jax
import pytest
import torch

from pets_face_recognition_tpu.engine.detector_controller import \
    DetectionController as JDetectionController
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn

from test_torch_port_bf16_train import (BUDGETS, STAGES, bf16_steps, check_gradients,
                                        check_losses, check_parameters, check_planted_fault)
from test_torch_port_mask_train import LOSS_TERMS, mask_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def step():
    cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=3, **BUDGETS)
    return bf16_steps(cfg, JDetectionController, mask_batch(), 23, jax.random.PRNGKey(9),
                      lambda dtype: maskrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=dtype,
                                                          **BUDGETS),
                      DetectionController)


def test_bf16_mask_step_losses_match_jax(step):
    """Each loss term (the mask loss included) and their sum."""
    check_losses(step, LOSS_TERMS)


def test_bf16_mask_step_gradients_match_jax(step):
    """Every parameter's gradient, float32."""
    check_gradients(step)


def test_bf16_mask_step_updated_parameters_match_jax(step):
    """Every float32 parameter after the SGD step."""
    check_parameters(step)


def test_bf16_mask_step_gradient_check_rejects_a_planted_fault(step):
    """K4-bf16's gradients doubled fail the gradient check."""
    check_planted_fault(step)
