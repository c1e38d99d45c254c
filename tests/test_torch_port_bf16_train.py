"""One whole keypoint R-CNN training step computing in bfloat16 against the
JAX package's, on the CPU: the JAX detector built as its training bench
builds it (``tools/bench_train.py:110-112``: trunk, FPN and model each
``clone(dtype=jnp.bfloat16)``), the port's ``keypointrcnn_resnet50_fpn(...,
dtype=torch.bfloat16)``, on the same float32 weights, batch and sampler
noise: the loss terms, every parameter's gradient and every parameter after
SGD. Parameters, gradients and the optimiser stay float32 on both sides.

The two routes differ: JAX pools the training RoIs through its separable XLA
form, the port through K3's and K4's bfloat16 instances (the Pallas
arithmetic). And on random weights the RPN's bfloat16 logits tie, so its
top-k is a near-tie: the port is given JAX's training proposals (its own
are counted, ``moved``), after which every decision (the samplers' ranks on
shared noise, the matches) is made on equal float32 boxes. bfloat16's own
move is JAX's alone: the distance of JAX's bfloat16 step from the port's
float32 step on the same input and proposals (the port's float32 step stands
for JAX's, to which ``test_torch_port_train.py`` holds it: 1e-4 for losses,
1e-3 for gradients and 1e-5 for the updated parameters, relative), the
largest over the batch and ``DRAWS`` copies of it with each pixel jittered
below bfloat16's resolution (each draw rounds otherwise; one draw's move in
a tensor of few degrees of freedom can land near 0). Each tensor of the
port's bfloat16 step is held to JAX's within twice that move plus the
float32 tolerance; a loss's floor is half a bfloat16 step of its value
(``BF16_LOSS``). The port's own bfloat16 result is in none of the bounds,
and a step whose K4-bf16 gradients are doubled fails them.

Sizes as ``test_torch_port_train.py``: trunk stages (1, 1, 1, 1) at full
widths, B = 2 images of 128 x 128, G = 2 boxes each, RPN budgets 64 / 32,
16 box samples an image.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.engine.detector_controller import \
    KeyPointsController as JKeyPointsController
from pets_face_recognition_tpu.losses import SumDetectionLoss
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils.optim import detection_sgd_optimizer as j_sgd
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.models import rcnn as p_rcnn
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.ops import roi_align
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer

from test_torch_port_models import ZERO_BY_CONSTRUCTION, jax_sampler_noise, randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, G = 2, 128, 2
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               box_batch_size_per_image=16)
LR = 5e-3
LOSS_TERMS = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
              "loss_keypoint")
F32_LOSS, F32_GRAD, F32_PARAM = 1e-4, 1e-3, 1e-5
# a loss reduces bfloat16 logits in float32: its floor is half a bfloat16 step
# of its value, since a scalar's own move, even the larger of the draws', can
# land near 0 (the Mask R-CNN step's loss_objectness of about 1.0: JAX's
# bfloat16 at most 1.7e-4 from float32, the port's 4.4e-4, the two 4.7e-4
# apart)
BF16_LOSS = 2.0 ** -9
# bfloat16's own move is JAX's on the batch and on DRAWS copies of it with
# each pixel jittered by up to JITTER relative (below bfloat16's resolution)
DRAWS, JITTER = 1, 2.0 ** -9


def bench_clone(model, dtype=jnp.bfloat16):
    """``tools/bench_train.py:110-112``: the trunk, the FPN and the model in ``dtype``."""
    inner = model.backbone.backbone.clone(dtype=dtype)
    fpn = model.backbone.clone(dtype=dtype, backbone=inner)
    return model.clone(dtype=dtype, backbone=fpn)


def jax_train_proposals(mod, images):
    """The training proposals of JAX's ``_forward_train`` (a flax ``method``
    of the detector)."""
    c = mod.cfg
    feats = mod.backbone(images, train=True)
    anchors, level_ids, _ = mod._anchors_and_levels(feats, images.shape[1:3])
    objectness, deltas = mod.rpn_head(feats)
    return j_rcnn.generate_proposals(
        objectness, deltas, anchors, level_ids, images.shape[1:3], c.rpn_pre_nms_top_n_train,
        c.rpn_post_nms_top_n_train, c.rpn_nms_thresh, num_levels=int(level_ids.max()) + 1)


def carried_proposals(mp, proposals, moved):
    """The port's ``generate_proposals`` in ``rcnn`` returns JAX's ``proposals``;
    ``moved`` collects how many of its own boxes differ from them."""
    real = p_rcnn.generate_proposals
    want = [torch.from_numpy(np.array(a)) for a in proposals]

    def carried(*args, **kw):
        boxes, valid = real(*args, **kw)
        near = ((boxes - want[0].to(boxes)).abs() <= 0.5).all(-1) & (valid == want[1])
        moved.append(int((~near).sum()))
        return want[0].to(boxes.device), want[1].to(valid.device)

    mp.setattr(p_rcnn, "generate_proposals", carried)


def port_step(controller_cls, model, batch, noise, mp, proposals, moved):
    ctl = controller_cls(optimizer_fn=lambda p: detection_sgd_optimizer(p, LR))
    state = ctl.init_state(0, "cpu", model=model)
    with mp.context() as m:
        carried_proposals(m, proposals, moved)
        out = ctl.train_step(state, batch, sampler_noise={k: torch.from_numpy(v)
                                                          for k, v in noise.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out, grads, params


def bf16_steps(cfg, j_controller_cls, batch, seed, key, port_factory, controller_cls):
    """JAX's bfloat16 step (the detector of ``cfg``, frozen-statistics trunk of
    ``STAGES``, cloned as the bench does) on weights randomized from ``seed``
    with sampler key ``key``, and the port's steps at ``dtype`` bfloat16 and
    float32 (``port_factory(dtype)``) on the same weights, noise and
    proposals; and bfloat16's own move (``own_moves``) from JAX's step and
    the port's float32 step on the batch and on ``DRAWS`` copies of it
    jittered below bfloat16's resolution."""
    j_det = bench_clone(j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(
        backbone=j_resnet.ResNet(stage_sizes=STAGES, features_only=True, frozen_stats=True)),
        cfg=cfg))
    config = types.SimpleNamespace(model=lambda: j_det,
                                   loss=lambda c, m: SumDetectionLoss(model=m),
                                   optimizer=lambda c: j_sgd(LR))
    ctl = j_controller_cls(config)
    targets = ctl._targets_from_batch(batch)
    images = jnp.asarray(batch["images"])
    shapes = jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images,
        targets, train=True))
    variables = randomize(shapes, np.random.RandomState(seed))

    def loss_fn(params, x):
        out = ctl.model_loss.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   x, targets, train=True, rngs={"sampler": key})
        return out["loss"], out

    j_step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    det_vars = {k: v["model"] for k, v in variables.items()}
    j_proposals = jax.jit(lambda v, x: j_det.apply(v, x, method=jax_train_proposals))
    B, H, W, _ = batch["images"].shape
    anchors = 3 * sum((H // s) * (W // s) for s in (4, 8, 16, 32, 64))
    noise = jax_sampler_noise(ctl.model_loss, variables, key, B, anchors,
                              cfg.rpn_post_nms_top_n_train + batch["boxes"].shape[1])
    tx = j_sgd(LR)
    mp = pytest.MonkeyPatch()
    sd = weights.to_tensors(weights.detection_state_dict(det_vars))
    moved = []

    def port(dtype, batch=batch, proposals=None):
        model = port_factory(dtype)
        model.load_state_dict(sd)
        return port_step(controller_cls, model, batch, noise, mp, proposals or jax_run[3], moved)

    jittered = np.random.RandomState(seed + 1)
    draws = []
    for r in range(DRAWS + 1):
        b = dict(batch, images=batch["images"] * (1 + JITTER * jittered.uniform(
            -1, 1, batch["images"].shape)).astype(np.float32) if r else batch["images"])
        x = jnp.asarray(b["images"])
        (_, j_out), j_grads = j_step(variables["params"], x)
        # JAX's SGD on its gradients (momentum starts at 0)
        updates, _ = tx.update(j_grads, tx.init(variables["params"]), variables["params"])
        j_new = jax.tree.map(lambda p, u: p + u, variables["params"], updates)
        proposals = j_proposals(det_vars, x)
        f32 = port(torch.float32, b, proposals)
        if r == 0:
            jax_run = (j_out, j_grads, j_new, proposals)
            runs = {torch.float32: f32}
        draws.append((
            {k: abs(float(j_out[k]) - f32[0][k]) for k in f32[0]},
            *({n: _dist(t, f32[i][n])[0] for n, t in weights.detection_state_dict(
                {"params": tree["model"]}).items()} for i, tree in ((1, j_grads), (2, j_new)))))
    own_moves = [{k: max(d[i][k] for d in draws) for k in draws[0][i]} for i in range(3)]
    runs[torch.bfloat16] = port(torch.bfloat16)
    j_out, j_grads, j_new, _ = jax_run
    return dict(runs=runs, port=port, moved=moved, j_out=j_out, own_moves=own_moves,
                j_grads=weights.detection_state_dict({"params": j_grads["model"]}),
                j_params=weights.detection_state_dict({"params": j_new["model"]}))


@pytest.fixture(scope="module")
def step():
    cfg = j_rcnn.RCNNConfig(num_classes=2, num_keypoints=3, box_detections_per_img=1,
                            **BUDGETS)
    return bf16_steps(cfg, JKeyPointsController, synthetic_keypoint_batch(B, IMG, IMG, G, seed=3),
                      21, jax.random.PRNGKey(7),
                      lambda dtype: keypointrcnn_resnet50_fpn(stage_sizes=STAGES, dtype=dtype,
                                                              **BUDGETS),
                      KeyPointsController)


def _dist(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want), max(np.linalg.norm(want), 1e-30)


def held(got, want, move, f32_tol) -> float:
    """``|got - want|`` over twice bfloat16's own move ``move`` (JAX's, the
    port's bfloat16 result is not in it) plus the float32 tolerance of the
    reference's magnitude; at most 1 passes."""
    err, norm = _dist(got, want)
    return err / (2 * move + f32_tol * norm)


def check_losses(step, terms):
    bf, move = step["runs"][torch.bfloat16][0], step["own_moves"][0]
    for term in ("loss",) + terms:
        want = float(step["j_out"][term])
        assert held(bf[term], want, move[term], BF16_LOSS) <= 1.0, (term, bf[term], want)


def gradient_ratios(step, grads) -> dict[str, float]:
    """Each gradient's ``held`` ratio; the heatmap predictor's bias, zero by
    construction, within 1e-5."""
    grads = dict(grads)
    for n in ZERO_BY_CONSTRUCTION:
        if n in grads:
            assert np.abs(grads.pop(n).numpy()).max() <= 1e-5
    return {n: held(g, step["j_grads"][n], step["own_moves"][1][n], F32_GRAD)
            for n, g in grads.items()}


def check_gradients(step):
    bf, f32 = step["runs"][torch.bfloat16][1], step["runs"][torch.float32][1]
    assert sorted(bf) == sorted(step["j_grads"])
    assert all(g.dtype == torch.float32 for g in bf.values())
    worst = gradient_ratios(step, bf)
    name = max(worst, key=worst.get)
    assert worst[name] <= 1.0, (name, worst[name])
    # the bfloat16 step is not the float32 one
    assert all(not torch.equal(g, f32[n]) for n, g in bf.items())


def check_parameters(step):
    bf = step["runs"][torch.bfloat16][2]
    for n, p in bf.items():
        assert p.dtype == torch.float32
        assert held(p, step["j_params"][n], step["own_moves"][2][n], F32_PARAM) <= 1.0, n


def check_planted_fault(step):
    """The gradient check rejects a step whose K4-bf16 level gradients are
    doubled."""
    real = roi_align.multilevel_roi_align_backward_bf16
    with pytest.MonkeyPatch.context() as m:
        m.setattr(roi_align, "multilevel_roi_align_backward_bf16",
                  lambda *a, **k: [2 * g for g in real(*a, **k)])
        faulty = step["port"](torch.bfloat16)[1]
    assert max(gradient_ratios(step, faulty).values()) > 1.0


def test_bf16_train_step_losses_match_jax(step):
    """Each loss term and their sum within twice bfloat16's own move."""
    check_losses(step, LOSS_TERMS)


def test_bf16_train_step_gradients_match_jax(step):
    """Every parameter's gradient, float32, within twice bfloat16's own move
    (L2 of each tensor); the heatmap predictor's bias, zero by construction,
    within 1e-5."""
    check_gradients(step)


def test_bf16_train_step_updated_parameters_match_jax(step):
    """Every float32 parameter after the SGD step within twice bfloat16's own
    move."""
    check_parameters(step)


def test_bf16_train_step_gradient_check_rejects_a_planted_fault(step):
    """K4-bf16's gradients doubled fail the gradient check."""
    check_planted_fault(step)


def test_bf16_train_step_runs_k3_and_k4_bf16(step, monkeypatch):
    """The port's bfloat16 step pools through K3's and K4's bfloat16 instances
    (their plain versions here), and JAX's proposals were carried: the count of
    the port's own boxes that differ is reported, not held."""
    calls = []
    for name in ("multilevel_roi_align_bf16", "multilevel_roi_align_backward_bf16"):
        real = getattr(roi_align, name)
        monkeypatch.setattr(roi_align, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    model = keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1), dtype=torch.bfloat16,
                                      **BUDGETS)
    batch = synthetic_keypoint_batch(1, 64, 64, 1, seed=4)
    t_ctl = KeyPointsController(optimizer_fn=lambda p: detection_sgd_optimizer(p, LR))
    state = t_ctl.init_state(0, "cpu", model=model)
    out = t_ctl.train_step(state, batch)
    assert np.isfinite(out["loss"])
    assert calls.count("multilevel_roi_align_bf16") == 2
    assert calls.count("multilevel_roi_align_backward_bf16") == 2
    print("proposals moved by bfloat16 near-ties:", step["moved"])
