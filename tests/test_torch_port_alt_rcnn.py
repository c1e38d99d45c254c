"""The five alternate R-CNN factories of the port against the JAX package's
on the CPU: ``swin_tiny_keypoint_rcnn``, ``fasterrcnn_resnet50_fpn``,
``mobile_net_v3_large_rcnn``, ``convnetx_tiny_rcnn`` and
``convnext_tiny_keypoint_rcnn``.

- At full width, every parameter and statistic of each port factory has the
  shape JAX gives it under the bridge's name (``jax.eval_shape`` of the JAX
  factory's ``init``: no compute), and the configurations agree: pyramid
  levels, anchors, ratios, budgets, detections.
- Eval parity on narrow-trunk twins (the factory's own configuration on both
  sides, the trunk narrowed as the existing tests cut ResNet depth, the
  MobileNetV3 one kept at full width): B = 2 at 128 x 128 (MobileNetV3 at 64
  x 64), seeded weights carried over by ``weights.detection_state_dict``.
  JAX pools through its float32 gather RoIAlign (``DENSE_ROI_ALIGN_MAX_CELLS``
  set to 0: the 2-level factories would take its bfloat16 dense einsum at
  this size, ROADMAP note 8); its CPU post-process pads differently (note
  17), so validity is held on every slot and the rest on valid ones.
- One training step of the Swin keypoint R-CNN and of ``convnetx_tiny_rcnn``
  against ``jax.value_and_grad`` of ``SumDetectionLoss`` on shared weights,
  batch and sampler noise: each loss term within 1e-4 relative, every
  gradient within 1e-3 relative in norm.
- ``drive_alt_factories`` on the CPU at 64 x 64.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import convnext as j_convnext
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import swin as j_swin
from pets_face_recognition_tpu_torch import drive_alt_factories, models, weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.models import convnext, rcnn, swin
from pets_face_recognition_tpu_torch.models.fpn import BackboneWithFPN
from pets_face_recognition_tpu_torch.models.resnet import ResNet

from test_torch_port_models import ZERO_BY_CONSTRUCTION, jax_sampler_noise
from test_torch_port_swin import randomize_alt

torch.set_num_threads(1)

NAMES = ("swin_tiny_keypoint_rcnn", "fasterrcnn_resnet50_fpn", "mobile_net_v3_large_rcnn",
         "convnetx_tiny_rcnn", "convnext_tiny_keypoint_rcnn")
B, IMG, G = 2, 128, 2
MOBILE_IMG = 64                   # the MobileNetV3 twin keeps its full-width trunk
SWIN = dict(hidden_dim=16, layers=(2, 2, 2, 2), heads=(2, 2, 2, 2), head_dim=8)
CONVNEXT = dict(depths=(1, 1, 2, 1), dims=(16, 24, 32, 48))
STAGES = (1, 1, 1, 1)
# eval budgets (the Faster R-CNN keeps 100 detections of 128 proposals)
EVAL = dict(rpn_pre_nms_top_n_test=256, rpn_post_nms_top_n_test=128)
TRAIN = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
             box_batch_size_per_image=16)


def _zeros(tree):
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)


def twins(name: str, **overrides):
    """The JAX factory's model with its trunk narrowed (``clone``), and the
    port's factory built from the same arguments with the same trunk put
    under its FPN."""
    j_det = getattr(j_rcnn, name)(**overrides)
    port = getattr(rcnn, name)(**overrides)
    fpn, levels = j_det.backbone, port.backbone.fpn.in_levels
    if name.startswith("swin"):
        body = j_swin.SwinTransformer(features_only=True, window_size=4, **SWIN)
        port.backbone = rcnn._fpn_over(
            swin.SwinTransformer(features_only=True, window_size=4, **SWIN), levels)
    elif name.startswith("convn"):
        body = j_convnext.ConvNeXt(features_only=True, **CONVNEXT)
        port.backbone = rcnn._fpn_over(convnext.ConvNeXt(features_only=True, **CONVNEXT), levels)
    elif name.startswith("faster"):
        body = j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True)
        port.backbone = BackboneWithFPN(ResNet(stage_sizes=STAGES, features_only=True))
    else:                                   # MobileNetV3-Large at full width
        body = fpn.backbone
    j_det = j_det.clone(backbone=fpn.clone(backbone=body))
    return j_det, port


@pytest.mark.parametrize("name", NAMES)
def test_full_width_factories_match_jax_shapes_and_config(name):
    """Every ``state_dict`` entry of the port's factory at full width has the
    shape of the JAX variable the bridge maps to it (the FPN's input widths:
    96..768 for Swin-T and ConvNeXt-T, 384 and 768 for the p4/p5 ConvNeXt,
    112 and 160 for MobileNetV3), and the configurations agree field by
    field (the port has no RPN matcher thresholds: JAX never reads them)."""
    j_det = getattr(j_rcnn, name)()
    port = getattr(models, name)()
    size = 224 if name.startswith("swin") else 128
    shapes = jax.eval_shape(lambda x: j_det.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, x, train=False),
        jnp.zeros((1, size, size, 3)))
    want = {k: v.shape for k, v in weights.detection_state_dict(_zeros(shapes)).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    j_cfg = dataclasses.asdict(j_det.cfg)
    for field, value in dataclasses.asdict(port.cfg).items():
        assert value == j_cfg[field], field
    assert port.backbone.fpn.in_levels == tuple(j_det.backbone.in_levels)
    assert port.num_anchors == len(j_det.cfg.anchor_sizes[0]) * len(j_det.cfg.aspect_ratios)


@pytest.fixture(scope="module", params=NAMES)
def eval_pair(request):
    name = request.param
    rng = np.random.RandomState(NAMES.index(name) + 40)
    side = MOBILE_IMG if name.startswith("mobile") else IMG
    images = rng.rand(B, side, side, 3).astype(np.float32)
    j_det, port = twins(name, **EVAL)
    variables = randomize_alt(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                             jnp.asarray(images)), rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rcnn.GeneralizedRCNN, "DENSE_ROI_ALIGN_MAX_CELLS", 0)
        want = jax.jit(lambda v, x: j_det.apply(v, x))(variables, jnp.asarray(images))
    port.load_state_dict(weights.to_tensors(weights.detection_state_dict(variables)),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images))
    return name, side, {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v)
                                                                 for k, v in want.items()}


def test_narrow_twin_eval_matches_jax(eval_pair):
    """Validity equal on every slot; on valid slots labels equal, boxes
    within 1e-4 (relative, and of the side), scores within 1e-5, keypoints
    within 1e-4 of the side and their scores 1e-4 relative."""
    name, side, got, want = eval_pair
    assert sorted(got) == sorted(want)
    D = 100 if name.startswith("faster") else 1
    assert got["boxes"].shape == want["boxes"].shape == (B, D, 4)
    ok = want["valid"]
    np.testing.assert_array_equal(got["valid"], ok)
    assert ok.sum() >= B, "too few detections to compare"
    np.testing.assert_array_equal(got["labels"][ok], want["labels"][ok])
    np.testing.assert_allclose(got["boxes"][ok], want["boxes"][ok], rtol=1e-4, atol=1e-4 * side)
    np.testing.assert_allclose(got["scores"][ok], want["scores"][ok], rtol=0, atol=1e-5)
    if "keypoints" in want:
        np.testing.assert_allclose(got["keypoints"][ok], want["keypoints"][ok], rtol=1e-4,
                                   atol=1e-4 * side)
        np.testing.assert_allclose(got["keypoints_scores"][ok], want["keypoints_scores"][ok],
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=["swin_tiny_keypoint_rcnn", "convnetx_tiny_rcnn"])
def step(request):
    name = request.param
    with_kp = "keypoint" in name
    batch = synthetic_keypoint_batch(B, IMG, IMG, G, seed=6)
    targets = {"boxes": batch["boxes"], "labels": batch["labels"] + 1, "valid": batch["valid"]}
    if with_kp:
        targets["keypoints"] = batch["keypoints"]
    images = jnp.asarray(batch["images"])
    j_det, port = twins(name, **TRAIN)
    model_loss = SumDetectionLoss(model=j_det)
    j_targets = {k: jnp.asarray(v) for k, v in targets.items()}
    shapes = jax.eval_shape(lambda: model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images, j_targets,
        train=True))
    variables = randomize_alt(shapes, np.random.RandomState(27))
    key = jax.random.PRNGKey(11)

    @jax.jit
    def grad_fn(params, x):
        def loss_fn(p):
            out = model_loss.apply({"params": p}, x, j_targets, train=True,
                                   rngs={"sampler": key})
            return out["loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, j_out), j_grads = grad_fn(variables["params"], images)
    # JAX against itself: the same step on images changed by float32 rounding
    # (1e-7 relative), three draws; the ConvNeXt step is held to 1e-3 outright
    j_spread = [weights.detection_state_dict({"params": grad_fn(variables["params"], images * (
        1 + jnp.asarray(np.random.RandomState(s).randn(*images.shape), jnp.float32) * 1e-7)
    )[1]["model"]}) for s in ((1, 2, 3) if with_kp else ())]
    strides = (16, 32, 64) if name.startswith("convnetx") else (4, 8, 16, 32, 64)
    n_anchors = port.num_anchors * sum((IMG // s) ** 2 for s in strides)
    noise = jax_sampler_noise(model_loss, variables, key, B, n_anchors,
                              TRAIN["rpn_post_nms_top_n_train"] + G)

    port.load_state_dict(weights.to_tensors(weights.detection_state_dict(
        {"params": variables["params"]["model"]})), strict=True)
    losses = port(torch.from_numpy(batch["images"]),
                  {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()},
                  sampler_noise={k: torch.from_numpy(v) for k, v in noise.items()})
    total = sum(losses.values())
    total.backward()
    t_out = {"loss": float(total.detach()), **{k: float(v.detach()) for k, v in losses.items()}}
    return dict(name=name, port=port, t_out=t_out, j_out={k: float(v) for k, v in j_out.items()},
                j_grads=weights.detection_state_dict({"params": j_grads["model"]}),
                j_spread=j_spread)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_train_step_losses_match_jax(step):
    """Each loss term and their sum: 1e-4 relative."""
    got, want = step["t_out"], step["j_out"]
    assert sorted(got) == sorted(want)
    assert ("loss_keypoint" in got) == step["name"].startswith("swin")
    for term, value in want.items():
        assert abs(got[term] - value) <= 1e-4 * abs(value), (term, got[term], value)


def test_train_step_gradients_match_jax(step):
    """Every parameter's gradient (the trunk's LayerNorms, Swin's position
    tables, ConvNeXt's layer scales included) against JAX's, within 1e-3
    relative in norm, or within JAX's own spread where that is wider. The
    Swin step is ill-conditioned in float32 (ROADMAP notes 9 and 21): its
    box and keypoint heads hold many ReLU inputs within rounding of 0, and
    rounding the input images differently (1e-7 relative) flips some of
    them, which moves every gradient upstream by ~1e-3 to ~1e-2 relative.
    The flips land each float32 run in one of a few discrete states (two of
    the three rounded JAX runs agree within 3e-5 of each other, and sit
    3.1e-3 at the median tensor from the unrounded one). So the port is held
    against the nearest of JAX's four runs (the images and three roundings):
    its worst and median tensor within the middle draw's worst and median
    distance from the unrounded run, or 1e-3. The ConvNeXt step, whose
    spread measured ~1e-5, is held to 1e-3 outright against JAX's one run.
    The keypoint predictor's bias, 0 by construction, within 1e-6 on both
    sides."""
    grads = {n: p.grad.numpy() for n, p in step["port"].named_parameters()}
    assert sorted(grads) == sorted(step["j_grads"])
    for n in ZERO_BY_CONSTRUCTION:
        if n in grads:
            assert np.abs(grads.pop(n)).max() <= 1e-6
            assert np.abs(step["j_grads"][n]).max() <= 1e-6
    worst_bound = median_bound = 1e-3
    if step["j_spread"]:
        spreads = [[_rel(d[n], step["j_grads"][n]) for n in grads] for d in step["j_spread"]]
        worst_bound = max(1e-3, float(np.median([max(s) for s in spreads])))
        median_bound = max(1e-3, float(np.median([np.median(s) for s in spreads])))
    runs = [step["j_grads"], *step["j_spread"]]
    errs = min(({n: _rel(grads[n], run[n]) for n in grads} for run in runs),
               key=lambda e: np.median(list(e.values())))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= worst_bound, (worst, errs[worst], worst_bound)
    assert np.median(list(errs.values())) <= median_bound, median_bound


def test_drive_alt_factories_on_the_cpu(capsys, monkeypatch):
    """``drive_alt_factories`` exits 0 on the CPU at 64 x 64 (the box-only
    factories at full width), printing each factory's record with a finite
    loss and nonzero gradients; ``drive()`` takes a model-making callable, so the Swin
    keypoint R-CNN runs here on its narrow twin (16 box samples an image); a
    step whose loss is not finite exits 1."""
    only = ["fasterrcnn_resnet50_fpn", "mobile_net_v3_large_rcnn", "convnetx_tiny_rcnn"]
    assert drive_alt_factories.main(["--size", "64", "--device", "cpu", "--only", *only]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[-1] == {"driven": only}
    for rec in lines[:-1]:
        assert rec["size"] == 64 and rec["eval_dets"] >= 1 and rec["grad_abs_sum"] > 0
        assert np.isfinite(rec["train_loss"]) and rec["eval_ms"] > 0
    budgets = dict(drive_alt_factories.SMALL, box_batch_size_per_image=16)
    rec = drive_alt_factories.drive(
        "swin_tiny_keypoint_rcnn",
        lambda: weights.init_random_(twins("swin_tiny_keypoint_rcnn", **budgets)[1], 0), IMG,
        True, "cpu", eval_repeats=1)
    assert np.isfinite(rec["train_losses"]["loss_keypoint"]) and rec["grad_abs_sum"] > 0

    monkeypatch.setattr(drive_alt_factories, "sum_detection_loss",
                        lambda losses: {"loss": sum(losses.values()) * float("nan")})
    assert drive_alt_factories.main(["--size", "64", "--device", "cpu", "--only",
                                     "mobile_net_v3_large_rcnn"]) == 1
    assert "non-finite loss" in capsys.readouterr().err
