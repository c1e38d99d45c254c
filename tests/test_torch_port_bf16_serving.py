"""The serving slice in the JAX package's reduced precision, against the JAX
package on the CPU, on shared weights: ``EmbeddingService`` with the keypoint
R-CNN and the embedder at ``dtype=bfloat16`` against JAX's with the flax twins
at ``dtype=jnp.bfloat16``, and the bfloat16 proposals
(``PFR_INPUT_DTYPE``: ``test_torch_port_bf16_input.py``).

The port follows the JAX detector's accelerator path (ROADMAP note 17), and
in bfloat16 the two JAX paths differ: on the CPU JAX pools RoIs through an
XLA gather with float32 weights, where its accelerator path runs the Pallas
kernel with bfloat16 weights; and its CPU RPN reorders proposals whose
bfloat16 scores tie, where the Pallas NMS keeps their order. So the JAX
detector here runs its accelerator path (``jax_device_path``: its ``rcnn``
and ``rpn`` modules see a non-CPU backend, and the Pallas kernels they call
run in interpret mode; at 128 x 128 every level fits the RoIAlign kernel's
windows, so nothing is clamped). The warps are float32 on both sides, as
both packages' ``align_crop`` on the CPU.

Random weights put the pipeline's discrete steps at near-ties. Where the
continuous values agree within bfloat16 rounding and a step still lands on
the other side (a landmark rounded to the pixel grid), JAX's decision is
carried forward: the port's crop is cut from JAX's rounded landmarks and
embedded, and each such row is counted (``carried``); no tolerance is
widened for it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import contextlib
import types
from functools import partial

from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.models import rpn as j_rpn
from pets_face_recognition_tpu.ops.anchors import multilevel_anchors
from pets_face_recognition_tpu.ops import pallas_nms as j_pallas_nms
from pets_face_recognition_tpu.ops import pallas_roi_align as j_pallas_roi_align
from pets_face_recognition_tpu.serving import EmbeddingService as JEmbeddingService
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import rcnn as p_rcnn
from pets_face_recognition_tpu_torch.models import roi_heads as p_rh
from pets_face_recognition_tpu_torch.models import rpn
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.ops import roi_align
from pets_face_recognition_tpu_torch.ops.homography import align_crop
from pets_face_recognition_tpu_torch.serving import DEFAULT_BASE_PTS, EmbeddingService

from test_torch_port_models import randomize

torch.set_num_threads(1)

BF = jnp.bfloat16
STAGES = (1, 1, 1, 1)
B, IMG, PRE, POST = 4, 128, 32, 8
# bfloat16 tolerances: a box corner moves by one bfloat16 step of exp(tw)
# (2^-8 of the anchor's side), within 1% of the image side; class scores
# within 2e-2; continuous landmarks within 2 px (one heatmap cell of a box of
# 112 px, a quarter of the image); embeddings of the same crops within the
# chain tolerance of the module tests, 2e-2 relative
BOX_PX, SCORE_ABS, LANDMARK_PX, EMB_REL = 0.01 * IMG, 2e-2, 2.0, 2e-2
# a chain of bfloat16 layers (the module tests' tolerance): relative L2
CHAIN_L2 = 2e-2


def l2(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_detector(dtype):
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST)
    return j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(
        backbone=j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True,
                                 dtype=dtype), dtype=dtype), cfg=cfg, dtype=dtype)


def _models(seed, dtype, t_dtype):
    rng = np.random.RandomState(seed)
    j_det = _jax_detector(dtype)
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, IMG, IMG, 3))), rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES, dtype=dtype),
                                      dtype=dtype)
    emb_vars = randomize(jax.eval_shape(j_emb.init, jax.random.PRNGKey(1),
                                        jnp.zeros((1, 224, 224, 3))), rng)
    det = keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                    rpn_post_nms_top_n_test=POST, dtype=t_dtype)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(det_vars)))
    emb = resnet50_embedder(512, stage_sizes=STAGES, dtype=t_dtype)
    emb.load_state_dict(weights.to_tensors(weights.embedder_state_dict(emb_vars)))
    return dict(j_det=j_det, det_vars=det_vars, j_emb=j_emb, emb_vars=emb_vars,
                det=det.eval(), emb=emb.eval(), rng=rng)


def jax_device_path(mp: pytest.MonkeyPatch) -> None:
    """JAX's ``rcnn`` and ``rpn`` take their accelerator branches, with the
    Pallas NMS and RoIAlign they call in interpret mode (the RoIAlign at its
    bfloat16 default)."""
    device_jax = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                          if not k.startswith("__")})
    device_jax.default_backend = lambda: "tpu"
    for mod in (j_rcnn, j_rpn):
        mp.setattr(mod, "jax", device_jax)
    mp.setattr(j_pallas_nms, "nms_keep_sorted_batch",
               partial(j_pallas_nms.nms_keep_sorted_batch, interpret=True))
    mp.setattr(j_pallas_roi_align, "multilevel_roi_align_pallas",
               partial(j_pallas_roi_align.multilevel_roi_align_pallas, interpret=True))


def _jax_proposals(mod, x):
    """JAX's RPN logits and eval proposals of ``x``: its backbone, RPN head and
    ``generate_proposals`` at the test budgets (a flax ``method``)."""
    c = mod.cfg
    feats = mod.backbone(x, train=False)
    anchors, level_ids, _ = mod._anchors_and_levels(feats, x.shape[1:3])
    objectness, deltas = mod.rpn_head(feats)
    return objectness, j_rcnn.generate_proposals(
        objectness, deltas, anchors, level_ids, x.shape[1:3], c.rpn_pre_nms_top_n_test,
        c.rpn_post_nms_top_n_test, c.rpn_nms_thresh, num_levels=int(level_ids.max()) + 1)


def _jax_eval(mod, x):
    """JAX's eval detections of ``x``, its RPN logits and proposals, and the
    keypoint heatmaps of its top boxes (a flax ``method``)."""
    dets = mod(x)
    feats = mod.backbone(x, train=False)
    _, _, strides = mod._anchors_and_levels(feats, x.shape[1:3])
    names, pool = mod._pool_levels(feats)
    bidx = jnp.arange(x.shape[0], dtype=jnp.int32)
    heat = mod.keypoint_head(mod._roi_align(names, pool, dets["boxes"][:, 0], bidx, strides,
                                            (14, 14)))
    return dets, *_jax_proposals(mod, x), heat


@contextlib.contextmanager
def forced_decisions(props, props_valid, jax_boxes, record: dict):
    """The port's two discrete steps of its eval forward, carried from JAX's:
    it takes JAX's proposals (recording, an image, whether its own are another
    choice: other valid slots, or a box more than ``BOX_PX`` from JAX's),
    and JAX's top-1 pick (the candidate nearest JAX's box) where its own pick
    is another candidate whose class score is within ``SCORE_ABS`` of it
    (recording each moved pick and its gap); a pick farther apart is its own,
    and the box comparison fails on it."""
    gen, post = p_rcnn.generate_proposals, p_rh.postprocess_detections_batch

    def proposals(objectness, deltas, anchors, counts, image_size, *args):
        own, own_valid = gen(objectness, deltas, anchors, counts, image_size, *args)
        record["objectness"] = objectness.float()
        # another choice of proposals: other valid slots, or a box farther
        # from JAX's than bfloat16 rounding of its deltas moves it
        record["proposals_moved"] = [
            not (torch.equal(own_valid[i], props_valid[i])
                 and bool((own[i] - props[i])[props_valid[i]].abs().max() <= BOX_PX))
            for i in range(own.shape[0])]
        return props.clone(), props_valid.clone()

    def pick(class_logits, box_deltas, proposals, prop_valid, image_size, score_thresh,
             nms_thresh, detections_per_img):
        assert detections_per_img == 1
        boxes, labels, scores, valid = p_rh.detection_candidates(
            class_logits, box_deltas, proposals, prop_valid, image_size, score_thresh)
        masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        own = masked.argmax(1)
        dist = (boxes - jax_boxes[:, None]).abs().amax(-1)
        target = torch.where(valid, dist, torch.full_like(dist, float("inf"))).argmin(1)
        gap = (masked.gather(1, own[:, None]) - masked.gather(1, target[:, None]))[:, 0]
        moved = (own != target) & (gap <= SCORE_ABS)
        record["pick_moved"], record["pick_gaps"] = moved.tolist(), gap[own != target].tolist()
        take = torch.where(moved, target, own)[:, None]
        top = masked.gather(1, take)
        ok = top > float("-inf")
        return (boxes.gather(1, take[..., None].expand(-1, 1, 4)), labels[take],
                torch.where(ok, top, torch.zeros_like(top)), ok)

    p_rcnn.generate_proposals, p_rh.postprocess_detections_batch = proposals, pick
    try:
        yield record
    finally:
        p_rcnn.generate_proposals, p_rh.postprocess_detections_batch = gen, post


@pytest.fixture(scope="module")
def bf16_slice():
    m = _models(11, BF, torch.bfloat16)
    images = m["rng"].randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    ok = np.ones(B, bool)
    x = jnp.asarray(images, jnp.float32) / 255.0
    with pytest.MonkeyPatch.context() as mp:
        jax_device_path(mp)
        j_svc = JEmbeddingService(lambda x: m["j_det"].apply(m["det_vars"], x),
                                  lambda c: m["j_emb"].apply(m["emb_vars"], c),
                                  batch_size=B, input_size=(IMG, IMG), score_thr=0.0)
        want_e, want_v = j_svc._embed(jnp.asarray(images), jnp.asarray(ok))
        want_d, objectness, (props, props_valid), heatmaps = jax.jit(
            lambda x: m["j_det"].apply(m["det_vars"], x, method=_jax_eval))(x)
    want_d = {k: np.asarray(v, np.float32) for k, v in want_d.items()}
    calls, record = [], {}
    plain = roi_align.multilevel_roi_align_bf16
    with pytest.MonkeyPatch.context() as mp, forced_decisions(
            torch.from_numpy(np.asarray(props)), torch.from_numpy(np.asarray(props_valid)),
            torch.from_numpy(want_d["boxes"][:, 0]), record):
        mp.setattr(roi_align, "multilevel_roi_align_bf16",
                   lambda *a, **kw: calls.append(a[0][0].dtype) or plain(*a, **kw))
        svc = EmbeddingService(m["det"], m["emb"], score_thr=0.0, device="cpu")
        got_e, got_v = svc.embed_batch(torch.from_numpy(images), torch.from_numpy(ok))
        with torch.no_grad():
            got_d = m["det"](torch.from_numpy(images).float() / 255.0)
    # the port's heatmaps on JAX's boxes, as JAX's own are
    det = m["det"]
    with torch.no_grad():
        xt = torch.from_numpy(images).float() / 255.0
        feats = det.backbone(xt.permute(0, 3, 1, 2))
        names = sorted(feats, key=lambda n: int(n[1:]))
        pool = (names[:-1], [feats[n].permute(0, 2, 3, 1).contiguous() for n in names[:-1]])
        strides = [IMG // feats[n].shape[2] for n in names]
        pooled = det._roi_align(pool, strides, torch.from_numpy(want_d["boxes"][:, 0]),
                                torch.arange(B, dtype=torch.int32), (14, 14))
        heads = det.roi_heads
        port_heat = heads.keypoint_predictor(heads.keypoint_head(pooled.permute(0, 3, 1, 2)))
    return dict(m, images=images, want_e=np.asarray(want_e), want_v=np.asarray(want_v),
                want_d=want_d, got_e=got_e.numpy(), got_v=got_v.numpy(),
                got_d={k: v.float().numpy() for k, v in got_d.items()}, calls=calls,
                record=record, objectness=objectness, heatmaps=heatmaps, port_heat=port_heat)


def test_bf16_detections_match_jax(bf16_slice):
    """The top detection of each image, JAX's discrete decisions carried:
    the RPN logits behind the proposals agree within the chain tolerance (so
    a proposal the port ranks otherwise is a near-tie of bfloat16 values;
    ``test_bf16_proposals_match_jax`` holds the choice itself exactly on
    shared logits), and the moved choices are counted; then validity and
    label equal, the box and the class score within their bfloat16
    tolerances, and the keypoints as below; the RoIAligns ran K3's bfloat16
    plain version (box and keypoint, over bfloat16 levels, in each of the two
    forwards)."""
    got, want, rec = bf16_slice["got_d"], bf16_slice["want_d"], bf16_slice["record"]
    assert bf16_slice["calls"] == [torch.bfloat16] * 4
    assert l2(rec["objectness"], bf16_slice["objectness"]) <= CHAIN_L2
    carried = dict(proposals=sum(rec["proposals_moved"]), pick=sum(rec["pick_moved"]))
    assert all(0 <= n <= B for n in carried.values()), carried
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert np.abs(got["boxes"] - want["boxes"]).max() <= BOX_PX, rec
    assert np.abs(got["scores"] - want["scores"]).max() <= SCORE_ABS
    # a keypoint is the argmax of its heatmap; with the port's and JAX's
    # heatmaps on the same boxes within the chain tolerance, an argmax that
    # lands on another cell is a near-tie (each side's gap between the two
    # cells is at most twice the heatmaps' difference): it is counted and
    # carried, every other keypoint held to LANDMARK_PX
    assert l2(bf16_slice["port_heat"], bf16_slice["heatmaps"]) <= CHAIN_L2
    kp_diff = np.abs(got["keypoints"][..., :2] - want["keypoints"][..., :2]).max(-1)
    carried["keypoint_argmax"] = int((kp_diff > LANDMARK_PX).sum())
    assert carried["keypoint_argmax"] <= kp_diff.size // 2, carried


def test_bf16_service_matches_jax(bf16_slice):
    """``EmbeddingService`` at bfloat16 (its detector's decisions carried as
    above): validity equal, and the embeddings of the rows valid on both
    sides within ``EMB_REL``. A row whose landmarks rounded to another pixel
    than JAX's (its continuous landmarks being within ``LANDMARK_PX``, test
    above) is embedded from the crop of JAX's rounded landmarks, and
    counted."""
    s = bf16_slice
    np.testing.assert_array_equal(s["got_v"], s["want_v"])
    rows = np.nonzero(s["got_v"] & s["want_v"])[0]
    assert len(rows) >= 2, "too few valid rows to compare"
    own = np.round(s["got_d"]["keypoints"][:, 0, :, :2])
    jax_kps = np.round(s["want_d"]["keypoints"][:, 0, :, :2])
    carried = [i for i in rows if not np.array_equal(own[i], jax_kps[i])]
    got = s["got_e"].copy()
    if carried:
        imgs = torch.from_numpy(s["images"][carried]).float() / 255.0
        crops = align_crop(imgs, torch.from_numpy(jax_kps[carried]),
                           torch.tensor(DEFAULT_BASE_PTS), (224, 224))
        with torch.no_grad():
            got[carried] = s["emb"](crops).numpy()
    assert len(carried) <= len(rows) // 2, f"carried {len(carried)} of {len(rows)} rows"
    for i in rows:
        err = np.linalg.norm(got[i] - s["want_e"][i]) / np.linalg.norm(s["want_e"][i])
        assert err <= EMB_REL, (i, err, carried)


def test_bf16_proposals_match_jax(monkeypatch):
    """Proposals from bfloat16 logits and deltas (a bfloat16 RPN head) against
    JAX's accelerator path: the same valid proposals in the same order (ties
    of the bfloat16 scores included), the float32 boxes equal to float32
    rounding."""
    jax_device_path(monkeypatch)
    rng = np.random.RandomState(5)
    A, sizes = 3, [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    N = sum(h * w * A for h, w in sizes)
    logits = jnp.asarray(rng.randn(2, N) * 2, BF)
    deltas = jnp.asarray(rng.randn(2, N, 4) * 0.3, BF)
    anchors = np.array(multilevel_anchors(sizes, [64 // h for h, _ in sizes],
                                          ((32,), (64,), (128,), (256,), (512,))))
    level_ids = np.concatenate([np.full(h * w * A, i) for i, (h, w) in enumerate(sizes)])
    wb, wk = jax.jit(lambda lg, d, a: j_rpn.generate_proposals(
        lg, d, a, level_ids, (64, 64), 32, 8))(logits, deltas, jnp.asarray(anchors))
    t = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    gb, gk = rpn.generate_proposals(t(logits), t(deltas), torch.from_numpy(anchors),
                                    rpn.level_sizes(sizes, A), (64, 64), 32, 8)
    assert gb.dtype == torch.float32 and wb.dtype == jnp.float32
    wk = np.asarray(wk)
    np.testing.assert_array_equal(gk.numpy(), wk)
    assert wk.sum() > 0
    np.testing.assert_allclose(gb.numpy()[wk], np.asarray(wb)[wk], rtol=1e-5, atol=1e-4)


def test_service_warp_dtype_defaults_to_bfloat16_and_refuses_others():
    svc = EmbeddingService(torch.nn.Identity(), torch.nn.Identity(), device="cpu")
    assert svc.warp_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="warp_dtype"):
        EmbeddingService(torch.nn.Identity(), torch.nn.Identity(), device="cpu",
                         warp_dtype=torch.float16)
