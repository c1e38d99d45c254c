"""The port's Mask R-CNN against the JAX package on the CPU, on the same
weights: the mask head, both box post-process paths (the class-aware NMS of
the JAX device path through K2, and the vmapped per-image one its CPU path
runs), the whole eval forward, the index-form NMS, and the weight bridges
(flax -> port, torchvision 0.12 flat and >= 0.13 nested -> port).

The trunk is cut to one block per stage; widths are the production ones (FPN
256, mask head 256). Images are 128 x 128, so both sides pool RoIs through the
gather RoIAlign, as the 320 x 320 serving configuration does.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import roi_heads as j_rh
from pets_face_recognition_tpu.ops import pallas_nms as j_pallas_nms
from pets_face_recognition_tpu.utils import torch_convert, torchvision_layouts
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import rcnn, roi_heads
from pets_face_recognition_tpu_torch.ops import nms

from test_torch_port_models import randomize

torch.set_num_threads(1)

j_nms = importlib.import_module("pets_face_recognition_tpu.ops.nms")

STAGES = (1, 1, 1, 1)
B, IMG, PRE, POST, D = 2, 128, 64, 32, 3


def jax_mask_rcnn(**overrides):
    cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=D,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST,
                            **overrides)
    return j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(31)
    j_det = jax_mask_rcnn()
    images = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                         jnp.asarray(images)), rng)
    det = rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                     rpn_post_nms_top_n_test=POST)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(variables)),
                        strict=True)
    want = jax.jit(lambda v, x: j_det.apply(v, x))(variables, jnp.asarray(images))
    return dict(variables=variables, det=det.eval(), images=images,
                want={k: np.asarray(v) for k, v in want.items()})


def test_mask_head_matches_jax(pair):
    """``MaskHead`` + ``MaskPredictor`` on 14 x 14 pooled RoIs: 28 x 28
    per-class logits within 1e-5."""
    rng = np.random.RandomState(32)
    pooled = rng.randn(5, 14, 14, 256).astype(np.float32)
    head = j_rh.MaskHead(2)
    want = np.asarray(head.apply({"params": pair["variables"]["params"]["mask_head"]},
                                 jnp.asarray(pooled)))
    heads = pair["det"].roi_heads
    with torch.no_grad():
        got = heads.mask_predictor(heads.mask_head(torch.from_numpy(pooled)
                                                   .permute(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (5, 28, 28, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _postprocess_inputs(seed, C):
    """Clustered proposals (so that NMS suppresses), random logits and deltas,
    some invalid proposals and some scores below 0.05."""
    rng = np.random.RandomState(seed)
    N = 96
    centres = rng.uniform(20, 108, (B, 6, 2))
    pick = rng.randint(0, 6, (B, N))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(B, N, 2) * 4
    wh = rng.uniform(10, 40, (B, N, 2))
    proposals = np.concatenate([c - wh / 2, c + wh / 2], -1).clip(0, IMG).astype(np.float32)
    logits = (rng.randn(B, N, C) * 2).astype(np.float32)
    deltas = (rng.randn(B, N, C, 4) * 0.1).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    return logits, deltas, proposals, valid


def _pallas_interpret(monkeypatch):
    real = j_pallas_nms.nms_keep_sorted_batch
    monkeypatch.setattr(j_pallas_nms, "nms_keep_sorted_batch",
                        lambda b, v, t: real(b, v, t, interpret=True))


@pytest.mark.parametrize("seed,C", [(0, 2), (1, 2), (2, 3), (3, 4)])
def test_postprocess_nms_matches_jax_device_path(monkeypatch, seed, C):
    """The class-aware NMS branch against the JAX device path
    (``postprocess_detections_batch``, its K2 in interpret mode): keep masks
    (through the outputs), labels and validity equal on every slot, padding
    included; boxes and scores within 1e-6."""
    _pallas_interpret(monkeypatch)
    logits, deltas, proposals, valid = _postprocess_inputs(seed, C)
    want = [np.asarray(x) for x in j_rh.postprocess_detections_batch(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(proposals), jnp.asarray(valid),
        (IMG, IMG), 0.05, 0.5, 5)]
    got = [x.numpy() for x in roi_heads.postprocess_detections_batch(
        torch.from_numpy(logits), torch.from_numpy(deltas), torch.from_numpy(proposals),
        torch.from_numpy(valid), (IMG, IMG), 0.05, 0.5, 5)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6 * IMG)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    assert want[3].sum() > B, "NMS kept too little to compare"


@pytest.mark.parametrize("seed,C", [(0, 2), (1, 2), (2, 3), (3, 4)])
def test_postprocess_nms_matches_jax_cpu_path(seed, C):
    """The same branch against the JAX CPU path (vmapped
    ``postprocess_detections``: ``batched_nms``, class offset ``max(boxes) +
    1``): validity equal, and on valid slots labels equal, boxes and scores
    within 1e-6. Padding slots differ by construction (the CPU path repeats
    candidate 0 there, with its score)."""
    logits, deltas, proposals, valid = _postprocess_inputs(seed, C)
    post = jax.vmap(lambda cl, bd, p, pv: j_rh.postprocess_detections(
        cl, bd, p, pv, (IMG, IMG), 0.05, 0.5, 5))
    want = [np.asarray(x) for x in post(jnp.asarray(logits), jnp.asarray(deltas),
                                        jnp.asarray(proposals), jnp.asarray(valid))]
    got = [x.numpy() for x in roi_heads.postprocess_detections_batch(
        torch.from_numpy(logits), torch.from_numpy(deltas), torch.from_numpy(proposals),
        torch.from_numpy(valid), (IMG, IMG), 0.05, 0.5, 5)]
    ok = want[3]
    np.testing.assert_array_equal(got[3], ok)
    np.testing.assert_array_equal(got[1][ok], want[1][ok])
    np.testing.assert_allclose(got[0][ok], want[0][ok], rtol=0, atol=1e-6 * IMG)
    np.testing.assert_allclose(got[2][ok], want[2][ok], rtol=0, atol=1e-6)


def test_postprocess_top1_path_unchanged():
    """``detections_per_img == 1`` keeps the argmax fast path: the same
    detection as the NMS branch's first slot."""
    logits, deltas, proposals, valid = (torch.from_numpy(a) for a in _postprocess_inputs(5, 2))
    one = roi_heads.postprocess_detections_batch(logits, deltas, proposals, valid,
                                                 (IMG, IMG), 0.05, 0.5, 1)
    many = roi_heads.postprocess_detections_batch(logits, deltas, proposals, valid,
                                                  (IMG, IMG), 0.05, 0.5, 3)
    for a, b in zip(one, many):
        torch.testing.assert_close(a[:, 0], b[:, 0], rtol=0, atol=0)


def test_mask_rcnn_eval_forward_matches_jax(pair):
    """The whole eval forward against JAX's on the CPU (its vmapped
    post-process): validity equal; on valid slots labels equal, boxes and
    masks within 1e-4, scores within 1e-5."""
    with torch.no_grad():
        got = {k: v.numpy() for k, v in pair["det"](torch.from_numpy(pair["images"])).items()}
    want = pair["want"]
    assert sorted(got) == sorted(want) == ["boxes", "labels", "masks", "scores", "valid"]
    assert got["masks"].shape == want["masks"].shape == (B, D, 28, 28)
    ok = want["valid"]
    np.testing.assert_array_equal(got["valid"], ok)
    assert ok.sum() >= B, "too few detections to compare"
    np.testing.assert_array_equal(got["labels"][ok], want["labels"][ok])
    np.testing.assert_allclose(got["boxes"][ok], want["boxes"][ok], rtol=1e-4, atol=1e-4 * IMG)
    np.testing.assert_allclose(got["scores"][ok], want["scores"][ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["masks"][ok], want["masks"][ok], rtol=0, atol=1e-4)
    assert np.isfinite(got["masks"]).all()


def test_keypoint_factories_keep_one_detection():
    """The JAX config's default is 100 detections; every keypoint factory
    and ``frozen_twin`` pass 1, Mask R-CNN 3."""
    assert rcnn.RCNNConfig().box_detections_per_img == 100
    assert rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES).cfg.box_detections_per_img == 1
    mobile = rcnn.mobile_net_v3_large_keypoint_rcnn(frozen_stats=False)
    assert mobile.cfg.box_detections_per_img == 1
    assert rcnn.frozen_twin(mobile).cfg.box_detections_per_img == 1
    assert rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES).cfg.box_detections_per_img == 3
    assert rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES,
                                      quant="int8").cfg.box_detections_per_img == 3
    with pytest.raises(ValueError, match="quant_scope"):
        rcnn.maskrcnn_resnet50_fpn(stage_sizes=STAGES, quant="int8", quant_scope="head")


@pytest.mark.parametrize("seed,thr", [(0, 0.5), (1, 0.7)])
def test_index_nms_through_k2_wrapper_matches_jax(monkeypatch, seed, thr):
    """``ops.nms.nms`` takes its keep mask from the K2 wrapper (the plain
    version for CPU tensors): one call a run, and the JAX result."""
    calls = []
    real = nms.nms_keep_sorted_batch_cuda
    monkeypatch.setattr(nms, "nms_keep_sorted_batch_cuda",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (48, 2))
    bx = np.concatenate([xy, xy + rng.uniform(5, 30, (48, 2))], -1).astype(np.float32)
    scores = rng.uniform(size=48).astype(np.float32)
    idx, ok = nms.nms(torch.from_numpy(bx), torch.from_numpy(scores), thr, 16)
    j_idx, j_ok = j_nms.nms(jnp.asarray(bx), jnp.asarray(scores), thr, 16)
    assert calls == [1]
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(j_idx)[np.asarray(j_ok)])


def _strip(sd, prefix="model."):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_mask_bridge_round_trip():
    """torchvision Mask R-CNN layout -> the JAX converter -> the port's
    bridge gives back every tensor unchanged (the deconv through ``_deconv``),
    and the port's Mask R-CNN loads it strictly."""
    sd = _strip(torchvision_layouts.maskrcnn_resnet50_fpn_sd(np.random.RandomState(0)))
    params, stats = torch_convert.convert_detection_model(sd, with_mask=True)
    back = weights.detection_state_dict({"params": params, "batch_stats": stats})
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    rcnn.maskrcnn_resnet50_fpn().load_state_dict(weights.to_tensors(back), strict=True)


@pytest.mark.parametrize("nested", [False, True])
def test_torchvision_maskrcnn_reader(nested):
    """The torchvision reader takes the flat 0.12 names and the nested
    >= 0.13 ones (``mask_head.{i-1}.0.*``, FPN and RPN ``.0``): the same port
    state dict, loaded strictly; every tensor as torchvision's but ``fc6``,
    whose columns go from ``(c, h, w)`` to ``(h, w, c)``."""
    flat = _strip(torchvision_layouts.maskrcnn_resnet50_fpn_sd(np.random.RandomState(3)))
    tv = _strip(torchvision_layouts.maskrcnn_resnet50_fpn_sd(np.random.RandomState(3),
                                                             nested=nested))
    sd = weights.torchvision_maskrcnn_state_dict(tv)
    assert sorted(sd) == sorted(flat)
    for k, v in flat.items():
        if k == "roi_heads.box_head.fc6.weight":
            v = v.reshape(1024, 256, 7, 7).transpose(0, 2, 3, 1).reshape(1024, -1)
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    rcnn.maskrcnn_resnet50_fpn().load_state_dict(weights.to_tensors(sd), strict=True)
