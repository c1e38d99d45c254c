"""The port's MobileNetV3-Large trunk, its live BatchNorm and the MobileNetV3
keypoint R-CNN against the JAX package on the CPU, on weights carried over by
``pets_face_recognition_tpu_torch.weights``; the serving build of the mobile
detector; and the torchvision-layout import (the fc6 column order).

Widths are the production ones (the MobileNetV3 table, FPN 256, box head
1024, keypoint head 512); the JAX variables are randomised (weights and
running statistics) so the bridge is exercised on every tensor. Float32;
convolutions sum in another order in the two frameworks, hence 1e-4 relative
where they chain.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from pets_face_recognition_tpu.models import mobilenet_v3 as j_mbv3
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import rpn as j_rpn
from pets_face_recognition_tpu.utils import torchvision_layouts
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.device import float32_matmuls
from pets_face_recognition_tpu_torch.models import rcnn
from pets_face_recognition_tpu_torch.models.mobilenet_v3 import MobileNetV3Large
from pets_face_recognition_tpu_torch.models.resnet import LiveBatchNorm2d
from pets_face_recognition_tpu_torch.models.rpn import generate_proposals, level_sizes
from pets_face_recognition_tpu_torch.ops.anchors import multilevel_anchors
from pets_face_recognition_tpu_torch.ops.roi_align import roi_levels
from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models

from test_torch_port_models import randomize, rel_err

torch.set_num_threads(1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [64, 65], ids=["even_fused_stem", "odd_plain_stem"])
def test_mobilenet_trunk_matches_jax(size):
    """All four taps at 1e-4 relative: at 64 the JAX trunk runs its
    space-to-depth stem, at 65 its plain 3x3/s2 one; the port runs the plain
    one on the same ``stem/kernel``."""
    rng = np.random.RandomState(size)
    model = j_mbv3.MobileNetV3Large(features_only=True, frozen_stats=True)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = MobileNetV3Large(features_only=True, frozen_stats=True)
    port.load_state_dict(weights.to_tensors(weights.mobilenet_state_dict(
        variables["params"], variables["batch_stats"])), strict=True)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert sorted(got) == ["c2", "c3", "c4", "c5"]
    for k in got:
        assert got[k].shape[1] == port.out_channels[k]
        assert rel_err(got[k].permute(0, 2, 3, 1), want[k]) < 1e-4, k


def test_mobilenet_classifier_matches_jax():
    """The classifier head (960-channel conv, mean, 1280 hard swish, logits)
    at 1e-4 relative; the squeeze widths are the JAX ``max(exp // 4, 8)``."""
    rng = np.random.RandomState(3)
    model = j_mbv3.MobileNetV3Large(num_classes=10)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = MobileNetV3Large(num_classes=10)
    port.load_state_dict(weights.to_tensors(weights.mobilenet_state_dict(
        variables["params"], variables["batch_stats"])), strict=True)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert got.shape == (2, 10)
    assert rel_err(got, want) < 1e-4
    assert port.blocks[3].se.fc1.out_channels == 18      # torchvision would give 24


def test_live_batchnorm_matches_flax():
    """Three training updates at momentum 0.9, eps 1e-3, against flax
    ``nn.BatchNorm(use_running_average=False)``: outputs at 1e-5 relative,
    running mean and (biased) variance after one and after three updates at
    1e-6 relative; then ``eval()`` normalises with the running statistics, as
    ``use_running_average=True``."""
    rng = np.random.RandomState(0)
    C = 6
    j_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    xs = [(rng.randn(2, 4, 4, C) * 2 + 0.5).astype(np.float32) for _ in range(3)]
    variables = j_bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = {"scale": (rng.rand(C) + 0.5).astype(np.float32),
              "bias": (rng.randn(C) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.randn(C) * 0.1).astype(np.float32),
             "var": (rng.rand(C) + 0.5).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    port = LiveBatchNorm2d(C, eps=1e-3, momentum=0.9)
    port.load_state_dict(weights.to_tensors({
        "weight": params["scale"], "bias": params["bias"],
        "running_mean": stats["mean"], "running_var": stats["var"]}), strict=True)
    port.train()
    for i, x in enumerate(xs):
        want, mutated = j_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": params, "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            got = port(nchw(x)).permute(0, 2, 3, 1)
        assert rel_err(got, want) < 1e-5, i
        if i in (0, 2):
            for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
                assert rel_err(getattr(port, ours), mutated["batch_stats"][theirs]) < 1e-6, \
                    (i, ours)
    j_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-3)
    want = j_eval.apply(variables, jnp.asarray(xs[0]))
    before = port.running_var.clone()
    with torch.no_grad():
        got = port.eval()(nchw(xs[0])).permute(0, 2, 3, 1)
    assert rel_err(got, want) < 1e-5
    assert torch.equal(port.running_var, before)


def test_torch_nn_batchnorm_is_not_flax():
    """The reason for the port's own norm: ``nn.BatchNorm2d`` at the matching
    momentum (``1 - 0.9``) moves its running variance with the unbiased
    variance, which differs at n = 32 values a channel by far more than the
    1e-6 the port's norm holds."""
    rng = np.random.RandomState(1)
    x = nchw(rng.randn(2, 4, 4, 3).astype(np.float32))
    ours, theirs = LiveBatchNorm2d(3, eps=1e-3, momentum=0.9), torch.nn.BatchNorm2d(
        3, eps=1e-3, momentum=0.1)
    with torch.no_grad():
        ours.train()(x)
        theirs.train()(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * biased, rtol=1e-6, atol=0)
    assert rel_err(theirs.running_var, ours.running_var) > 1e-3


def _detector_pair(image: int, B: int, seed: int, **budgets):
    rng = np.random.RandomState(seed)
    j_det = j_rcnn.mobile_net_v3_large_keypoint_rcnn(**budgets)
    images = rng.rand(B, image, image, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                         jnp.asarray(images)), rng)
    det = rcnn.mobile_net_v3_large_keypoint_rcnn(**budgets)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(variables)),
                        strict=True)
    return j_det, variables, det.eval(), images


def _jax_rpn_intermediates(j_det, variables, images):
    """JAX pyramid, proposals, keep mask and the proposals' RoI levels."""

    def run(m, x):
        feats = m.backbone(x, train=False)
        anchors, level_ids, strides = m._anchors_and_levels(feats, x.shape[1:3])
        obj, deltas = m.rpn_head(feats)
        c = m.cfg
        props, valid = j_rpn.generate_proposals(
            obj, deltas, anchors, level_ids, x.shape[1:3], c.rpn_pre_nms_top_n_test,
            c.rpn_post_nms_top_n_test, c.rpn_nms_thresh, num_levels=int(level_ids.max()) + 1)
        return feats, props, valid

    return jax.jit(lambda v, x: j_det.apply(v, x, method=run))(variables, jnp.asarray(images))


@pytest.mark.parametrize("image,B,dense_limit", [(320, 1, None), (128, 2, 0)],
                         ids=["320_dense_einsum", "128_gather"])
def test_mobile_detector_matches_jax(monkeypatch, image, B, dense_limit):
    """The eval detector at both of JAX's eval RoIAlign routes: at 320, B = 1
    its pyramid (p4 + p5 = 500 cells) pools by the dense einsum; at 128, B = 2
    with the dense limit set to 0, by the gather. Equal RPN keep masks and RoI
    levels of the proposals, the pyramid at 1e-4 relative, and the top box,
    score and keypoints at 1e-4 (the port pools by the plain K3)."""
    if dense_limit is not None:
        monkeypatch.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", dense_limit)
    budgets = dict(rpn_pre_nms_top_n_test=128, rpn_post_nms_top_n_test=16)
    j_det, variables, det, images = _detector_pair(image, B, 30 + image, **budgets)
    j_feats, j_props, j_valid = _jax_rpn_intermediates(j_det, variables, images)
    want = jax.jit(lambda v, x: j_det.apply(v, x))(variables, jnp.asarray(images))
    x = torch.from_numpy(images)
    with torch.no_grad(), float32_matmuls():
        got = det(x)
        feats = det.backbone(x.permute(0, 3, 1, 2))
        names = sorted(feats, key=lambda n: int(n[1:]))
        sizes = [tuple(feats[n].shape[2:]) for n in names]
        obj, deltas = det.rpn([feats[n] for n in names])
        anchors = multilevel_anchors(sizes, [image // h for h, _ in sizes],
                                     det.cfg.anchor_sizes, det.cfg.aspect_ratios)
        props, valid = generate_proposals(obj, deltas, anchors,
                                          level_sizes(sizes, det.num_anchors), (image, image),
                                          128, 16, det.cfg.rpn_nms_thresh)
    assert names == ["p4", "p5", "p6"] and det.num_anchors == 15
    for n in names:
        assert rel_err(feats[n].permute(0, 2, 3, 1), j_feats[n]) < 1e-4, n
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(props.numpy(), np.asarray(j_props), rtol=1e-4, atol=1e-3)
    v = valid.numpy()
    np.testing.assert_array_equal(
        roi_levels(props[valid], 4, 5).numpy(),
        roi_levels(torch.from_numpy(np.asarray(j_props)[v]), 4, 5).numpy())
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["keypoints"].numpy()[..., :2],
                               np.asarray(want["keypoints"])[..., :2], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["keypoints_scores"].numpy(),
                               np.asarray(want["keypoints_scores"]), rtol=1e-4, atol=1e-4)


def test_mobile_roi_align_reads_levels_from_the_pyramid(monkeypatch):
    """Both RoIAligns of the mobile detector get ``min_level = 4`` and
    ``max_level = 5`` and the strides of p4 and p5, so the canonical mapper
    clamps to [4, 5] and K4's pre-pass sees strides 16 and 32."""
    seen = []
    inner = rcnn.multilevel_roi_align_diff

    def spy(feats, rois, bidx, output_size, strides, **kw):
        seen.append((len(feats), tuple(strides), kw["min_level"], kw["max_level"]))
        return inner(feats, rois, bidx, output_size, strides, **kw)

    monkeypatch.setattr(rcnn, "multilevel_roi_align_diff", spy)
    det = weights.init_random_(rcnn.mobile_net_v3_large_keypoint_rcnn(
        rpn_pre_nms_top_n_test=16, rpn_post_nms_top_n_test=4), 0).eval()
    with torch.no_grad():
        det(torch.rand(1, 64, 64, 3))
    assert seen == [(2, (16, 32), 4, 5)] * 2


def test_mobile_factory_refuses_int8_keypoint_head():
    """``quant_kp`` builds the int8 keypoint head (the MobileNetV3 trunk has
    no int8 path, as in JAX); a mode other than calibrate or int8 is refused."""
    from pets_face_recognition_tpu_torch.models import quant

    det = rcnn.mobile_net_v3_large_keypoint_rcnn(quant_kp="int8")
    assert {k.split(".")[1] for k in quant.quant_state(det)} == {"keypoint_head"}
    with pytest.raises(ValueError, match="quant mode"):
        rcnn.mobile_net_v3_large_keypoint_rcnn(quant_kp="int4")


def test_mobile_serving_models_stay_in_eval_and_embed():
    """``build_serving_models(detector_kind="mobile")``: every module in eval
    mode (a live norm left in train() would switch to batch statistics), the
    2-level pyramid, and ``embed_batch`` gives finite (B, 512) embeddings;
    an unknown kind raises."""
    det, emb, base = build_serving_models("cpu", seed=0, detector_kind="mobile")
    assert not any(m.training for m in det.modules())
    assert not any(isinstance(m, LiveBatchNorm2d) for m in det.modules())
    assert det.num_anchors == 15 and det.cfg.rpn_post_nms_top_n_test == 16
    svc = EmbeddingService(det, emb, base, score_thr=0.0, device="cpu")
    imgs = torch.randint(0, 256, (2, 128, 128, 3), generator=torch.Generator().manual_seed(0),
                         dtype=torch.uint8)
    e, v = svc.embed_batch(imgs, torch.ones(2, dtype=torch.bool))
    assert e.shape == (2, 512) and bool(torch.isfinite(e).all()) and v.shape == (2,)
    with pytest.raises(ValueError, match="detector kind"):
        build_serving_models("cpu", detector_kind="swin")


def test_torchvision_import_permutes_fc6_columns():
    """A torchvision keypoint R-CNN state dict (random, nested FPN names)
    loads strictly into the port, and the port's box head on NHWC pooled RoIs
    equals torchvision's computation, which flattens NCHW ``(c, h, w)``, with
    the original weights: within 1e-5. Loaded without the permutation, the
    head differs (the fault the import closes)."""
    rng = np.random.RandomState(0)
    tv = {k[len("model."):]: v for k, v in torchvision_layouts.keypointrcnn_resnet50_fpn_sd(
        rng, nested=True).items()}
    sd = weights.torchvision_keypoint_state_dict(tv)
    det = rcnn.keypointrcnn_resnet50_fpn()
    det.load_state_dict(weights.to_tensors(sd), strict=True)
    pooled = torch.from_numpy(rng.randn(5, 7, 7, 256).astype(np.float32))
    w6, b6 = (torch.from_numpy(tv[f"roi_heads.box_head.fc6.{n}"]) for n in ("weight", "bias"))
    w7, b7 = (torch.from_numpy(tv[f"roi_heads.box_head.fc7.{n}"]) for n in ("weight", "bias"))
    with torch.no_grad():
        got = det.roi_heads.box_head(pooled)
        flat = pooled.permute(0, 3, 1, 2).reshape(5, -1)          # torchvision: (c, h, w)
        want = torch.relu(torch.relu(flat @ w6.T + b6) @ w7.T + b7)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        det.roi_heads.box_head.fc6.weight.copy_(w6)
        assert (det.roi_heads.box_head(pooled) - want).abs().max() > 1e-2
