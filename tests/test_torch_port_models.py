"""Port models against the JAX package on the CPU, on weights carried over by
``pets_face_recognition_tpu_torch.weights``: ResNet trunk (plain 7x7 stem
against the fused space-to-depth stem), embedder, FPN, RPN head and proposals,
box/keypoint heads, the top-1 postprocess and the keypoint decode.

Sizes are small (one block per stage, narrow heads, tiny images). The JAX
variables are randomised (weights, BN statistics) so the bridge is exercised
on every tensor. Float32 throughout; convolution sums run in another order in
the two frameworks, hence relative tolerances of 1e-4 where convolutions chain.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import roi_heads as j_rh
from pets_face_recognition_tpu.models import rpn as j_rpn
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import embedder, fpn, resnet, roi_heads, rpn

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)


def randomize(tree, rng):
    """Random arrays of the shapes in ``tree`` (arrays or ``jax.eval_shape``
    structs): kernels ~ N(0, 1/fan_in), norm scales
    and variances in [0.5, 1.5], biases and means ~ 0.1 N(0, 1)."""

    def leaf(path, x):
        name = path[-1].key
        shape = tuple(x.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            return rng.randn(*shape).astype(np.float32) / np.sqrt(fan_in)
        if name in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load(module, sd):
    module.load_state_dict(weights.to_tensors(sd), strict=True)
    return module.eval()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def trunk():
    rng = np.random.RandomState(0)
    model = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    return model, variables, x


@pytest.mark.parametrize("fused_stem", [True, False])
def test_resnet_trunk_matches_jax(trunk, fused_stem):
    """The port's plain 7x7/s2 stem agrees with the JAX space-to-depth stem
    (``fused_stem=True``, the default) and with its plain one."""
    model, variables, x = trunk
    model = model.clone(fused_stem=fused_stem)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = load(resnet.ResNet(STAGES, features_only=True),
                weights.resnet_state_dict(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("c2", "c3", "c4", "c5"):
        assert rel_err(got[k].permute(0, 2, 3, 1), want[k]) < 1e-4, k


def test_embedder_matches_jax():
    rng = np.random.RandomState(1)
    model = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    sd = weights.embedder_state_dict(variables)
    # flax's live BatchNorm keeps no counter, and neither does the port's
    assert "bn1.running_var" in sd and not any(k.endswith("num_batches_tracked") for k in sd)
    port = load(embedder.resnet50_embedder(512, stage_sizes=STAGES), sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 512)
    assert rel_err(got, want) < 1e-4


def test_fpn_matches_jax():
    rng = np.random.RandomState(2)
    chans = (16, 32, 64, 128)
    feats = {f"c{i + 2}": rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32)
             for i, c in enumerate(chans)}
    model = j_fpn.FPN(out_channels=32)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(2), jfeats), rng)
    want = jax.jit(model.apply)(variables, jfeats)
    port = load(fpn.FPN(chans, 32), weights.fpn_state_dict(variables["params"]))
    with torch.no_grad():
        got = port({k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()})
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        assert rel_err(got[k].permute(0, 2, 3, 1), want[k]) < 1e-5, k


@pytest.fixture(scope="module")
def rpn_case():
    rng = np.random.RandomState(3)
    C, A = 16, 3
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    feats = {f"p{i + 2}": rng.randn(2, h, w, C).astype(np.float32)
             for i, (h, w) in enumerate(sizes)}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    model = j_rpn.RPNHead(num_anchors=A)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(3), jfeats), rng)
    head = load(rpn.RPNHead(C, A), weights.rpn_head_state_dict(variables["params"]))
    return model, variables, head, feats, sizes, A


def test_rpn_head_matches_jax(rpn_case):
    model, variables, head, feats, _, _ = rpn_case
    want_l, want_d = jax.jit(model.apply)(variables, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got_l, got_d = head([torch.from_numpy(feats[k]).permute(0, 3, 1, 2)
                             for k in sorted(feats)])
    assert rel_err(got_l, want_l) < 1e-5
    assert rel_err(got_d, want_d) < 1e-5


@pytest.mark.parametrize("pre,post", [(32, 8), (64, 24)])
def test_generate_proposals_matches_jax(rpn_case, pre, post):
    """Plain K2 inside the port's proposals against the JAX CPU path (vmapped
    index-form ``nms``): the same valid proposals in the same order."""
    from pets_face_recognition_tpu.ops.anchors import multilevel_anchors

    _, _, _, _, sizes, A = rpn_case
    rng = np.random.RandomState(pre)
    N = sum(h * w * A for h, w in sizes)
    logits = rng.randn(2, N).astype(np.float32) * 2
    deltas = rng.randn(2, N, 4).astype(np.float32) * 0.3
    strides = [64 // h for h, _ in sizes]
    anchors = np.array(multilevel_anchors(sizes, strides,
                                          ((32,), (64,), (128,), (256,), (512,))))
    level_ids = np.concatenate([np.full(h * w * A, i) for i, (h, w) in enumerate(sizes)])
    wb, wk = jax.jit(lambda lg, d, a: j_rpn.generate_proposals(
        lg, d, a, level_ids, (64, 64), pre, post))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors))
    gb, gk = rpn.generate_proposals(torch.from_numpy(logits), torch.from_numpy(deltas),
                                    torch.from_numpy(anchors),
                                    rpn.level_sizes(sizes, A), (64, 64), pre, post)
    wk = np.asarray(wk)
    np.testing.assert_array_equal(gk.numpy(), wk)
    assert wk.sum() > 0
    np.testing.assert_allclose(gb.numpy()[wk], np.asarray(wb)[wk], rtol=1e-5, atol=1e-4)


def test_box_heads_match_jax():
    rng = np.random.RandomState(4)
    K, C = 6, 8
    pooled = rng.randn(K, 7, 7, C).astype(np.float32)
    jh, jp = j_rh.TwoMLPHead(representation_size=1024), j_rh.FastRCNNPredictor(2)
    vh = randomize(jax.eval_shape(jh.init, jax.random.PRNGKey(4), jnp.asarray(pooled)), rng)
    feats = jax.jit(jh.apply)(vh, jnp.asarray(pooled))
    vp = randomize(jax.eval_shape(jp.init, jax.random.PRNGKey(5), feats), rng)
    want_s, want_d = jax.jit(jp.apply)(vp, feats)
    sd = weights.box_heads_state_dict(vh["params"], vp["params"])
    head = roi_heads.TwoMLPHead(7 * 7 * C)
    pred = roi_heads.FastRCNNPredictor(1024, 2)
    load(head, {k[len("box_head."):]: v for k, v in sd.items() if k.startswith("box_head.")})
    load(pred, {k[len("box_predictor."):]: v for k, v in sd.items()
                if k.startswith("box_predictor.")})
    with torch.no_grad():
        got_s, got_d = pred(head(torch.from_numpy(pooled)))
    assert rel_err(got_s, want_s) < 1e-5
    assert rel_err(got_d, want_d) < 1e-5


def test_keypoint_heads_match_jax():
    rng = np.random.RandomState(5)
    K, C, NK = 2, 16, 3
    pooled = rng.randn(K, 14, 14, C).astype(np.float32)
    model = j_rh.KeypointHead(num_keypoints=NK, channels=32)
    variables = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(6), jnp.asarray(pooled)), rng)
    want = jax.jit(model.apply)(variables, jnp.asarray(pooled))
    sd = weights.keypoint_heads_state_dict(variables["params"])
    head, pred = roi_heads.KeypointHead(C, channels=32), roi_heads.KeypointPredictor(32, NK)
    load(head, {k[len("keypoint_head."):]: v for k, v in sd.items()
                if k.startswith("keypoint_head.")})
    load(pred, {k[len("keypoint_predictor."):]: v for k, v in sd.items()
                if k.startswith("keypoint_predictor.")})
    with torch.no_grad():
        got = pred(head(torch.from_numpy(pooled).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (K, 56, 56, NK)
    assert rel_err(got, want) < 1e-4


def test_postprocess_top1_matches_jax():
    rng = np.random.RandomState(6)
    B, N, C = 3, 16, 2
    logits = rng.randn(B, N, C).astype(np.float32)
    deltas = rng.randn(B, N, C, 4).astype(np.float32) * 0.5
    xy = rng.uniform(0, 200, (B, N, 2)).astype(np.float32)
    props = np.concatenate([xy, xy + rng.uniform(10, 120, (B, N, 2))], -1).astype(np.float32)
    valid = rng.rand(B, N) > 0.3
    valid[2] = False  # an image with no valid proposal
    want = jax.jit(lambda *a: j_rh.postprocess_detections_batch(
        *a, (256, 256), detections_per_img=1))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(props), jnp.asarray(valid))
    got = roi_heads.postprocess_detections_batch(
        torch.from_numpy(logits), torch.from_numpy(deltas), torch.from_numpy(props),
        torch.from_numpy(valid), (256, 256))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ok = np.asarray(want[3])[:, 0]
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok], atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy()[ok], np.asarray(want[1])[ok])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


def test_heatmaps_to_keypoints_matches_jax():
    """Peaked heatmaps (as CE-trained heads give) with noise, boxes of several
    sizes; the decode includes a peak on the map border."""
    rng = np.random.RandomState(7)
    K, S, NK = 4, 56, 3
    yy, xx = np.mgrid[0:S, 0:S]
    maps = rng.randn(K, S, S, NK).astype(np.float32) * 0.05
    for k in range(K):
        for j in range(NK):
            cy, cx = rng.uniform(0, S - 1, 2) if (k, j) != (0, 0) else (0.0, S - 1.0)
            maps[k, :, :, j] += 4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    boxes = np.array([[10, 20, 234, 244], [0, 0, 60, 90], [100, 50, 400, 200],
                      [5, 5, 40, 41]], np.float32)
    want_k, want_s = jax.jit(j_rh.heatmaps_to_keypoints)(jnp.asarray(maps), jnp.asarray(boxes))
    got_k, got_s = roi_heads.heatmaps_to_keypoints(torch.from_numpy(maps),
                                                   torch.from_numpy(boxes))
    # same argmax cells; positions are (cell + 0.5) * w / 224 + x1 in float32
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def jax_sampler_noise(model_loss, variables, key, B, n_anchors, n_box):
    """The sampler noise of ``GeneralizedRCNN._forward_train`` for ``rngs={'sampler':
    key}``: ``(B, n_anchors)`` for the RPN and ``(B, n_box)`` for the box head."""
    rng = model_loss.apply(variables, rngs={"sampler": key},
                           method=lambda m: m.model.make_rng("sampler"))
    rpn_rng, box_rng = jax.random.split(rng)

    def draw(k, n):
        return np.stack([np.asarray(jax.random.uniform(kb, (n,)))
                         for kb in jax.random.split(k, B)])

    return {"rpn": draw(rpn_rng, n_anchors), "box": draw(box_rng, n_box)}


# Exactly zero in exact arithmetic: the bias of the heatmap predictor shifts
# all 56 x 56 logits of a heatmap alike, the 2x bilinear upsample gives every
# output the weight 1 in all, and the softmax cross entropy's gradient over
# the positions of a heatmap sums to 0. Both frameworks leave ~1e-8 of float32
# rounding, so the tensor is held to 1e-6 absolute on both sides instead.
ZERO_BY_CONSTRUCTION = ("roi_heads.keypoint_predictor.kps_score_lowres.bias",)
