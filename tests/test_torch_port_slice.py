"""The port's serving slice against the JAX package on the CPU, on the same
weights: keypoint R-CNN (ResNet-FPN, 3 keypoints, top-1) -> rounded-landmark
projective align -> ResNet embedder, and the weight bridge's round trip over
the production checkpoint layouts.

The trunks are cut to one block per stage; widths are the production ones
(FPN 256, keypoint head 512, embedder 512). Images are 128x128 so the 4-level
pyramid (1360 cells) is above the JAX detector's dense-RoIAlign limit and both
sides run the gather RoIAlign, as the 320x320 serving configuration does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.serving import EmbeddingService as JEmbeddingService
from pets_face_recognition_tpu.utils import torch_convert, torchvision_layouts
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.serving import EmbeddingService

from test_torch_port_models import randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, PRE, POST = 2, 128, 32, 8


@pytest.fixture(scope="module")
def chain():
    rng = np.random.RandomState(11)
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    j_det = j_rcnn.GeneralizedRCNN(
        backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
            stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)
    images = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0), jnp.asarray(images)),
                         rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    emb_vars = randomize(jax.eval_shape(j_emb.init, jax.random.PRNGKey(1),
                                             jnp.zeros((1, 224, 224, 3))), rng)

    det = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                    rpn_post_nms_top_n_test=POST)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(det_vars)))
    emb = resnet50_embedder(512, stage_sizes=STAGES)
    emb.load_state_dict(weights.to_tensors(weights.embedder_state_dict(emb_vars)))
    return dict(j_det=j_det, det_vars=det_vars, j_emb=j_emb, emb_vars=emb_vars,
                det=det.eval(), emb=emb.eval(), images=images)


def test_detector_matches_jax(chain):
    """Pre-threshold top detection: box, score and (B, 3, 2) keypoints."""
    want = jax.jit(lambda v, x: chain["j_det"].apply(v, x))(
        chain["det_vars"], jnp.asarray(chain["images"]))
    with torch.no_grad():
        got = chain["det"](torch.from_numpy(chain["images"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    # softmax of float32 logits after a conv chain: ~1e-6 relative
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-4, atol=1e-3)
    # keypoints are argmax cells of the bicubic window, scaled by the box:
    # equal cells give positions equal to float32 rounding of the box
    np.testing.assert_allclose(got["keypoints"].numpy()[..., :2],
                               np.asarray(want["keypoints"])[..., :2], atol=1e-3)
    np.testing.assert_allclose(got["keypoints_scores"].numpy(),
                               np.asarray(want["keypoints_scores"]), rtol=1e-4, atol=1e-4)


def test_service_matches_jax_chain(chain):
    """``embed_batch`` against the JAX ``EmbeddingService`` device graph at f32:
    validity equal, embeddings equal on rows valid on both sides. The score
    threshold is 0 so that random weights leave valid rows to compare."""
    rng = np.random.RandomState(12)
    images = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    ok = np.array([True, True])
    j_det, j_emb = chain["j_det"], chain["j_emb"]
    j_svc = JEmbeddingService(
        lambda x: j_det.apply(chain["det_vars"], x),
        lambda c: j_emb.apply(chain["emb_vars"], c),
        batch_size=B, input_size=(IMG, IMG), score_thr=0.0, warp_dtype=jnp.float32)
    want_e, want_v = j_svc._embed(jnp.asarray(images), jnp.asarray(ok))
    svc = EmbeddingService(chain["det"], chain["emb"], score_thr=0.0, device="cpu")
    got_e, got_v = svc.embed_batch(torch.from_numpy(images), torch.from_numpy(ok))
    want_v = np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v.any(), "no row valid on both sides"
    want_e = np.asarray(want_e)[want_v]
    # crops agree to ~1e-3 (two homography solves); the embedder's chain of
    # float32 convolutions keeps that at ~1e-3 relative
    err = np.abs(got_e.numpy()[want_v] - want_e).max() / np.abs(want_e).max()
    assert err < 5e-3


def test_embed_batch_rejects_close_landmarks(chain):
    """The > 5 px landmark rule and the score threshold gate validity."""
    svc = EmbeddingService(chain["det"], chain["emb"], score_thr=1.1, device="cpu")
    imgs = torch.zeros(1, IMG, IMG, 3, dtype=torch.uint8)
    emb, valid = svc.embed_batch(imgs, torch.ones(1, dtype=torch.bool))
    assert emb.shape == (1, 512) and not valid.any()


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_detection_bridge_round_trip():
    """torchvision keypoint R-CNN layout -> JAX converter -> port bridge gives
    back every tensor unchanged, and the port detector loads it strictly."""
    sd = _strip(torchvision_layouts.keypointrcnn_resnet50_fpn_sd(
        np.random.RandomState(0)), "model.")
    params, stats = torch_convert.convert_detection_model(sd, num_keypoints=3)
    back = weights.detection_state_dict({"params": params, "batch_stats": stats})
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    keypointrcnn_resnet50_fpn().load_state_dict(weights.to_tensors(back), strict=True)


def test_embedder_bridge_round_trip():
    sd = _strip(torchvision_layouts.fe_controller_sd(np.random.RandomState(1)),
                "model.model.")
    params, stats = torch_convert.convert_fe_embedder({"model." + k: v for k, v in sd.items()})
    back = weights.embedder_state_dict({"params": params, "batch_stats": stats})
    # the port's live norms, as flax's, keep no num_batches_tracked counter
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    resnet50_embedder().load_state_dict(weights.to_tensors(back), strict=True)
