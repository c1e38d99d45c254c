"""The port's training pieces against the JAX package on the CPU, on the same
numpy inputs and the same sampler noise: the RPN matcher and sampler, the box
sampler (its slot order included), the losses, the keypoint heatmap targets,
proposals at the training budget of 2000 boxes a level, and the SGD step with
its schedule and clipping. Tolerances say why they are not 0 where they are
not.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pets_face_recognition_tpu import losses as j_losses
from pets_face_recognition_tpu.models import roi_heads as j_rh
from pets_face_recognition_tpu.models import rpn as j_rpn
from pets_face_recognition_tpu.ops import anchors as j_anchors
from pets_face_recognition_tpu.utils import optim as j_optim
from pets_face_recognition_tpu_torch import losses
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
from pets_face_recognition_tpu_torch.engine.trainer import Trainer
from pets_face_recognition_tpu_torch.models import roi_heads, rpn
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.utils import DictWrapper, optim

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt(rng, B, M, image=64.0):
    xy = rng.uniform(0, image * 0.6, (B, M, 2)).astype(np.float32)
    wh = rng.uniform(8, image * 0.4, (B, M, 2)).astype(np.float32)
    valid = np.ones((B, M), bool)
    valid[-1, -1] = False
    return np.concatenate([xy, xy + wh], -1), valid


def _rpn_anchors():
    sizes, strides = [(16, 16), (8, 8), (4, 4)], [4, 8, 16]
    return np.asarray(j_anchors.multilevel_anchors(sizes, strides, ((16,), (32,), (64,))))


def test_rpn_matcher_and_sampler_match_jax(rng):
    """Anchor labels, matched boxes and the balanced sample on the same noise:
    equal."""
    anchors = _rpn_anchors()
    gt, gv = _gt(rng, 2, 3)
    labels, matched = rpn.assign_rpn_targets(_t(anchors), _t(gt), _t(gv))
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    noise = np.stack([np.asarray(jax.random.uniform(k, (len(anchors),))) for k in keys])
    got = rpn.sample_balanced(labels, _t(noise), 64, 0.5)
    for b in range(2):
        wl, wm = j_rpn.assign_rpn_targets(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                          jnp.asarray(gv[b]))
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(matched[b].numpy(), np.asarray(wm))
        ws = j_rpn.sample_balanced(wl, keys[b], 64, 0.5)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ws))
        assert (np.asarray(wl) == 1).sum() > 0 and np.asarray(ws).sum() == 64


def test_select_training_samples_matches_jax_in_order(rng):
    """Box sampling on the same noise: boxes, classes, matched GT, validity and
    fg equal, slot for slot. With 300 proposals the float32 ``1e-9`` order key
    has runs of equal values, so the slot order is not ascending; the test
    checks that the quirk shows and is copied."""
    B, S0, M, ns = 2, 300, 3, 128
    gt, gv = _gt(rng, B, M)
    labels = rng.randint(0, 2, (B, M)).astype(np.int32) + 1
    props = np.concatenate([gt[:, rng.randint(0, M, S0)]
                            + rng.uniform(-6, 6, (B, S0, 4)).astype(np.float32)], 0)
    props[:, ::7] = _gt(rng, B, S0)[0][:, ::7]          # some background
    pv = rng.uniform(size=(B, S0)) > 0.1
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    noise = np.stack([np.asarray(jax.random.uniform(k, (S0 + M,))) for k in keys])
    got = roi_heads.select_training_samples(_t(props), _t(pv), _t(gt), _t(labels), _t(gv),
                                            _t(noise), ns, 0.25, 0.5, 0.5)
    for b in range(B):
        want = j_rh.select_training_samples(
            jnp.asarray(props[b]), jnp.asarray(pv[b]), jnp.asarray(gt[b]),
            jnp.asarray(labels[b]), jnp.asarray(gv[b]), keys[b], ns, 0.25, 0.5, 0.5)
        for name, a, w in zip(("boxes", "cls", "gt_idx", "valid", "fg"), got, want):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(w), err_msg=name)
    valid = got[3][0].numpy()
    assert valid.sum() == ns and got[4][0].sum() > 0
    all_boxes = np.concatenate([props[0], gt[0]])
    slot = [int(np.nonzero((all_boxes == bx).all(1))[0][0]) for bx in got[0][0].numpy()]
    assert slot != sorted(slot)


def test_losses_match_jax(rng):
    """Cross entropy (weighted), sigmoid BCE and smooth-L1: 1e-6 relative."""
    logits = rng.randn(12, 5).astype(np.float32) * 3
    labels = rng.randint(0, 5, 12)
    w = (rng.uniform(size=12) > 0.3).astype(np.float32)
    for weights in (None, w):
        got = losses.cross_entropy(_t(logits), _t(labels), None if weights is None else _t(weights))
        want = j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    x = rng.randn(40).astype(np.float32) * 5
    t = (rng.uniform(size=40) > 0.5).astype(np.float32)
    np.testing.assert_allclose(losses.optax_sigmoid_ce(_t(x), _t(t)).numpy(),
                               np.asarray(j_losses.optax_sigmoid_ce(jnp.asarray(x),
                                                                    jnp.asarray(t))),
                               rtol=1e-6)
    p, q = rng.randn(30).astype(np.float32) * 0.3, rng.randn(30).astype(np.float32) * 0.3
    np.testing.assert_allclose(losses.smooth_l1(_t(p), _t(q)).numpy(),
                               np.asarray(j_losses.smooth_l1(jnp.asarray(p), jnp.asarray(q))),
                               rtol=1e-6)


def test_rpn_and_box_losses_match_jax(rng):
    """``rpn_loss`` (the JAX keys rebuilt into noise) and ``fastrcnn_loss``:
    1e-6 relative."""
    anchors = _rpn_anchors()
    N = len(anchors)
    gt, gv = _gt(rng, 2, 3)
    obj = rng.randn(2, N).astype(np.float32)
    dts = rng.randn(2, N, 4).astype(np.float32) * 0.2
    key = jax.random.PRNGKey(6)
    noise = np.stack([np.asarray(jax.random.uniform(k, (N,)))
                      for k in jax.random.split(key, 2)])
    got = rpn.rpn_loss(_t(obj), _t(dts), _t(anchors), _t(gt), _t(gv), _t(noise), 64, 0.5)
    want = j_rpn.rpn_loss(jnp.asarray(obj), jnp.asarray(dts), jnp.asarray(anchors),
                          jnp.asarray(gt), jnp.asarray(gv), key, 64, 0.5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)

    K, C = 24, 2
    cls_logits = rng.randn(K, C).astype(np.float32)
    deltas = rng.randn(K, C, 4).astype(np.float32)
    boxes, matched = _gt(rng, 1, K)[0][0], _gt(rng, 1, K)[0][0]
    cls_t = rng.randint(0, C, K)
    valid = rng.uniform(size=K) > 0.2
    fg = valid & (cls_t > 0)
    got = roi_heads.fastrcnn_loss(_t(cls_logits), _t(deltas), _t(boxes), _t(cls_t),
                                  _t(matched), _t(valid), _t(fg))
    want = j_rh.fastrcnn_loss(*map(jnp.asarray, (cls_logits, deltas, boxes, cls_t, matched,
                                                 valid, fg)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_keypoint_targets_and_loss_match_jax(rng):
    """Heatmap targets equal (indices and validity, far-edge and outside points
    included); the keypoint loss 1e-6 relative."""
    K, NK, S = 10, 3, 56
    boxes = _gt(rng, 1, K)[0][0]
    kps = np.stack([rng.uniform(boxes[:, 0] - 5, boxes[:, 2] + 5, (NK, K)).T,
                    rng.uniform(boxes[:, 1] - 5, boxes[:, 3] + 5, (NK, K)).T,
                    (rng.uniform(size=(K, NK)) > 0.2).astype(np.float32)], -1).astype(np.float32)
    kps[0, 0, :2] = boxes[0, 2:]                          # on the far edge
    idx, vis = roi_heads.keypoints_to_heatmap_targets(_t(kps), _t(boxes), S)
    w_idx, w_vis = j_rh.keypoints_to_heatmap_targets(jnp.asarray(kps), jnp.asarray(boxes), S)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(w_vis))
    assert vis.any() and not vis.all()
    logits = rng.randn(K, S, S, NK).astype(np.float32)
    fg = rng.uniform(size=K) > 0.3
    got = roi_heads.keypointrcnn_loss(_t(logits), idx, vis, _t(fg))
    want = j_rh.keypointrcnn_loss(jnp.asarray(logits), w_idx, w_vis, jnp.asarray(fg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_generate_proposals_at_training_budget_matches_jax():
    """Proposals at the training budget (2000 pre-NMS per level, 2000 kept) on
    the pyramid of a 128 x 128 image, through the plain K2 at K = 2000 against
    the JAX CPU path: equal keep masks; valid boxes to 1e-3 px."""
    rng = np.random.RandomState(5)
    sizes, A = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)], 3
    N = sum(h * w * A for h, w in sizes)
    logits = rng.randn(2, N).astype(np.float32) * 2
    deltas = rng.randn(2, N, 4).astype(np.float32) * 0.3
    strides = [128 // h for h, _ in sizes]
    anchors = np.asarray(j_anchors.multilevel_anchors(sizes, strides,
                                                      ((32,), (64,), (128,), (256,), (512,))))
    level_ids = np.concatenate([np.full(h * w * A, i) for i, (h, w) in enumerate(sizes)])
    wb, wk = jax.jit(lambda lg, d, a: j_rpn.generate_proposals(
        lg, d, a, level_ids, (128, 128), 2000, 2000))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors))
    gb, gk = rpn.generate_proposals(_t(logits), _t(deltas), _t(anchors),
                                    rpn.level_sizes(sizes, A), (128, 128), 2000, 2000)
    wk = np.asarray(wk)
    np.testing.assert_array_equal(gk.numpy(), wk)
    assert 100 < wk.sum(1).min()
    np.testing.assert_allclose(gb.numpy()[wk], np.asarray(wb)[wk], rtol=0, atol=1e-3)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_sgd_step_matches_optax(rng, clip):
    """Three steps of ``detection_sgd_optimizer`` (momentum 0.9, weight decay
    1e-4) with a milestone after the first, optionally behind the global-norm
    clip, against the JAX package's ``optax`` chain: 1e-6 relative."""
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = j_optim.wrap_gradient_transform(
        j_optim.detection_sgd_optimizer(5e-3, milestones_steps=[1]), clip)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, schedule = optim.detection_sgd_optimizer(t_params.values(), 5e-3,
                                                  milestones_steps=[1])
    assert [schedule(i) for i in range(3)] == pytest.approx([5e-3, 5e-4, 5e-4])
    for step, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for k, p in t_params.items():
            p.grad = _t(g[k])
        if clip:
            optim.clip_by_global_norm_(t_params.values(), clip)
        optim.set_learning_rate(opt, schedule(step))
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")


def test_synthetic_batch_follows_the_batch_contract():
    b = synthetic_keypoint_batch(3, 64, 48, 2, seed=0)
    assert b["images"].shape == (3, 64, 48, 3) and b["images"].dtype == np.float32
    assert b["boxes"].shape == (3, 2, 4) and b["keypoints"].shape == (3, 2, 3, 3)
    assert b["valid"].tolist() == [[True, False], [True, True], [True, False]]
    box, kp = b["boxes"][b["valid"]], b["keypoints"][b["valid"]]
    assert (kp[..., 0] > box[:, None, 0]).all() and (kp[..., 0] < box[:, None, 2]).all()
    assert (kp[..., 1] > box[:, None, 1]).all() and (kp[..., 1] < box[:, None, 3]).all()
    assert (box[:, 2] <= 48).all() and (box[:, 3] <= 64).all()
    np.testing.assert_array_equal(b["boxes"], synthetic_keypoint_batch(3, 64, 48, 2, 0)["boxes"])


def _tiny_detector():
    return keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1), rpn_pre_nms_top_n_train=32,
                                     rpn_post_nms_top_n_train=16, box_batch_size_per_image=8)


def test_trainer_steps_the_controller_on_the_cpu(tmp_path):
    """``Trainer.fit`` runs the controller's steps (the +1 label shift, sampler
    noise from the state's seed and step, SGD) and logs every step's finite
    loss dict to ``metrics.jsonl``; the same seed gives the same losses."""
    batch = synthetic_keypoint_batch(2, 64, 64, 2, seed=1)
    runs = []
    for i in range(2):
        config = DictWrapper(dict(seed=0, model=_tiny_detector,
                                  optimizer=lambda c: optim.detection_sgd_optimizer,
                                  train_dataloader=lambda: [batch, batch]))
        # two fixed batches, no validation, no checkpoint, a log every step
        trainer = Trainer(config, logger=MetricsLogger(tmp_path / str(i)), max_epochs=1,
                          overfit_batches=2, log_every_n_steps=1, enable_checkpointing=False,
                          device="cpu")
        state = trainer.fit(KeyPointsController(config=config))
        records = [json.loads(line) for line in
                   (tmp_path / str(i) / "metrics.jsonl").read_text().splitlines()]
        logged = [r for r in records if "loss" in r]
        assert state.step == 2 and len(logged) == 2
        runs.append([{k: v for k, v in m.items() if k not in ("step", "time")} for m in logged])
    for m in runs[0]:
        assert set(m) == {"loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                          "loss_box_reg", "loss_keypoint"}
        assert all(np.isfinite(v) for v in m.values())
    assert runs[0] == runs[1]


def test_controller_clips_the_global_gradient_norm():
    """With ``gradient_clip_val`` the step's gradients (left in ``.grad``) have
    a global norm of at most the clip value."""
    ctl = KeyPointsController(_tiny_detector, gradient_clip_val=1e-3)
    state = ctl.init_state(0, "cpu")
    ctl.train_step(state, synthetic_keypoint_batch(2, 64, 64, 2, seed=2))
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in state.model.parameters()))
    assert float(norm) <= 1e-3 * (1 + 1e-5)
