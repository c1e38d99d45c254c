"""The port's data parallelism (``parallel/``, the controllers' ``mesh``) on a
2-rank ``gloo`` group on the CPU, against JAX's 2-device sharded steps and
against the port's one rank on the whole batch.

The two ranks are subprocesses of this file (``python
test_torch_port_parallel.py <rank> <inputs> <outputs>``, one intra-op
thread each; a third, ``one``, runs one rank on the whole batch) joined
through ``COORDINATOR_ADDRESS=localhost:<free port>``,
``NUM_PROCESSES=2`` and ``PROCESS_ID``; the JAX side runs here on 2 of
conftest's 8 virtual CPU devices, with the batch sharded over a ``data``
axis. They check:

- an FE step (the embedder cut to one block a stage at production width,
  live BatchNorm, ArcFace, B = 4 of 64 x 64): loss, gradients and running
  statistics on both ranks. Gradients are held to JAX's own float32 spread
  under 1e-6 input rounding, as ``test_torch_port_fe_train.py`` does (ROADMAP
  note 9); the loss to 1e-4, the running statistics to 1e-5 (relative in
  norm). With each rank's own BatchNorm moments the gradients miss by far
  more (the median tensor by more than 10x the bound);
- a Mask R-CNN and a keypoint R-CNN step over ``resnet18`` trunks at 64 x 64
  (B = 4, the dry run's budgets), on JAX's sampler noise, rank ``r`` on its
  rows: the ranks hold different numbers of boxes, so of foreground RoIs,
  and rank 1 has hidden keypoints. Losses within 1e-4 of JAX; gradients
  within 1e-5 of one rank (relative in norm, the worst tensor) and within
  1e-3 of JAX (the median tensor, and the worst within 1e-3 more than JAX's
  own spread under 1e-7 input rounding, two draws; the heatmap predictor's
  bias, whose gradient is 0 in exact arithmetic, within 1e-6 absolute on
  every side, as ``test_torch_port_train.py`` holds it). The same step with
  each rank dividing by its own counts (plain DDP) misses one rank's mask or
  keypoint head gradients by more than 1e-2, while its box head, whose count
  (the sampled RoIs, 16 an image) the ranks share, agrees within 1e-5. A
  Mask R-CNN step drawing its own noise from
  the step's generator takes its rows of the whole batch's draw: within 1e-5
  of one rank;
- ``sharded_topk_scores`` over a gallery of 101 rows (uneven over 2 ranks)
  with tied rows: indices equal to JAX's and to a stable top-k of the
  one-rank scores, scores within 1e-6; ``pairwise_card_scores`` and
  ``calc_scores`` with the mesh equal to one rank's;
- ``EmbeddingService.embed_batch`` over the mesh: every rank returns the
  whole batch, equal to one rank's (1e-5), and a batch size that does not
  divide raises JAX's ``ValueError``;
- ``Trainer.fit`` of the Mask R-CNN controller over a ``DataLoader`` (each
  rank reads only its rows), its validation and rank 0's checkpoint, and the
  FE and Mask R-CNN controllers' gathered ``run_eval_batch``: against one
  rank (the bounds in ``test_fit_and_eval_over_two_ranks_match_one_rank``);
- ``init_distributed`` and ``device_info`` on a world of one and on the
  group, ``shard_batch`` and a sharded ``DataLoader`` raising on an
  indivisible batch.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch

from pets_face_recognition_tpu_torch import parallel, retrieval, weights
from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
from pets_face_recognition_tpu_torch.data_loading.loader import DataLoader
from pets_face_recognition_tpu_torch.engine.checkpoint import load_checkpoint
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.engine import trainer as trainer_module
from pets_face_recognition_tpu_torch.engine.trainer import Trainer
from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.fpn import BackboneWithFPN
from pets_face_recognition_tpu_torch.models.rcnn import (GeneralizedRCNN, RCNNConfig,
                                                         keypointrcnn_resnet50_fpn)
from pets_face_recognition_tpu_torch.models.resnet import resnet18
from pets_face_recognition_tpu_torch.serving import EmbeddingService
from pets_face_recognition_tpu_torch.utils import DictWrapper
from pets_face_recognition_tpu_torch.utils.optim import detection_sgd_optimizer, fe_sgd_optimizer
from pets_face_recognition_tpu_torch.weights import init_random_

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

WORLD = 2
STAGES = (1, 1, 1, 1)
FE_B, FE_IMG, C, D = 4, 64, 8, 512
DET_B, DET_IMG, G = 4, 64, 2
# the JAX dry run's detection budgets (__graft_entry__.py)
BUDGETS = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
               rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=16,
               rpn_batch_size_per_image=32, box_batch_size_per_image=16,
               box_detections_per_img=2)
N_ANCHORS = 3 * sum((DET_IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
FE_LR, DET_LR = 1e-2, 5e-3
FE_INPUT_ROUNDING, DET_INPUT_ROUNDING = 1e-6, 1e-7
GALLERY, QUERIES, DIM = 101, 5, 16


# -- what both sides build ----------------------------------------------------

def fe_wrapper(sd=None) -> SoftmaxBasedMetricLearning:
    model = SoftmaxBasedMetricLearning(resnet50_embedder(D, stage_sizes=STAGES), D, C)
    if sd is not None:
        model.load_state_dict(weights.to_tensors(sd), strict=True)
    return model


def fe_controller(mesh=None) -> Controller:
    factory = partial(fe_sgd_optimizer, lr=FE_LR)
    return Controller(DictWrapper({"optimizer": lambda c: factory}), mesh=mesh)


def detector(kind: str, sd=None) -> GeneralizedRCNN:
    cfg = RCNNConfig(num_classes=2, with_mask=kind == "mask",
                     num_keypoints=3 if kind == "keypoint" else 0, **BUDGETS)
    body = resnet18(features_only=True, frozen_stats=True)
    model = GeneralizedRCNN(BackboneWithFPN(body, in_channels=body.level_channels), cfg)
    if sd is not None:
        model.load_state_dict(weights.to_tensors(sd), strict=True)
    return model


def det_controller(mesh=None) -> DetectionController:
    return DetectionController(optimizer_fn=lambda p: detection_sgd_optimizer(p, DET_LR),
                               mesh=mesh)


def det_batch(kind: str) -> dict:
    """Rank 0 (images 0, 1) holds 2 and 1 boxes, rank 1 (images 2, 3) 1 and
    1, smaller; rank 1's second image hides two of its keypoints."""
    batch = synthetic_keypoint_batch(DET_B, DET_IMG, DET_IMG, G, seed=11)
    batch["valid"][:] = [[True, True], [True, False], [True, False], [True, False]]
    batch["boxes"][0, 1] = (20.0, 20.0, 52.0, 52.0)
    batch["keypoints"][0, 1] = ((26.0, 28.0, 1.0), (44.0, 30.0, 1.0), (35.0, 44.0, 1.0))
    batch["boxes"][2:, 0] = ((8.0, 10.0, 26.0, 24.0), (36.0, 30.0, 50.0, 46.0))
    batch["keypoints"][2, 0] = ((12.0, 14.0, 1.0), (21.0, 15.0, 1.0), (17.0, 20.0, 1.0))
    batch["keypoints"][3, 0] = ((40.0, 34.0, 0.0), (46.0, 35.0, 0.0), (43.0, 41.0, 1.0))
    if kind == "mask":
        del batch["keypoints"]
        yy, xx = np.mgrid[:DET_IMG, :DET_IMG] + 0.5
        masks = np.zeros((DET_B, G, DET_IMG, DET_IMG), np.float32)
        for b, g in zip(*np.nonzero(batch["valid"])):
            x1, y1, x2, y2 = batch["boxes"][b, g]
            cx, cy, ax, ay = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
            masks[b, g] = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
        batch["masks"] = masks
    return batch


def fe_batch() -> dict:
    rng = np.random.RandomState(3)
    return {"x": rng.rand(FE_B, FE_IMG, FE_IMG, 3).astype(np.float32),
            "label": rng.randint(0, C, FE_B).astype(np.int32),
            "index": np.arange(FE_B, dtype=np.int32)}


def gallery():
    rng = np.random.RandomState(7)
    g = rng.randn(GALLERY, DIM).astype(np.float32)
    g[[10, 60, 99]] = g[3]                       # ties across and within shards
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = rng.randn(QUERIES, DIM).astype(np.float32)
    q[0] = g[3]
    return q / np.linalg.norm(q, axis=1, keepdims=True), g


def service(mesh=None, batch_size: int = 4) -> EmbeddingService:
    det = init_random_(keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=32,
                                                 rpn_post_nms_top_n_test=8), 0).eval()
    emb = init_random_(resnet50_embedder(512, stage_sizes=STAGES), 1).eval()
    return EmbeddingService(det, emb, score_thr=0.0, device="cpu", batch_size=batch_size,
                            mesh=mesh)


def serve_images() -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.RandomState(9)
    return (torch.from_numpy(rng.randint(0, 255, (4, 128, 128, 3)).astype(np.uint8)),
            torch.ones(4, dtype=torch.bool))


class ReadLog(list):
    """A map-style dataset of samples that logs every index it is asked for."""

    def __init__(self, samples):
        super().__init__(samples)
        self.read = []

    def __getitem__(self, i):
        self.read.append(int(i))
        return super().__getitem__(i)


def fit_and_eval(data, root: Path, mesh=None) -> dict:
    """The FE and Mask R-CNN controllers' ``run_eval_batch`` on the initial
    weights; then ``Trainer.fit``: one epoch of the Mask R-CNN controller
    over a shuffled ``DataLoader`` of 8 samples (the mask batch's 4 images
    twice: 2 global batches of 4), validating on the mask batch and
    checkpointing into ``root``; then ``validate`` once more."""
    val = det_batch("mask")
    samples = ReadLog([{k: v[i % DET_B] for k, v in val.items()} for i in range(2 * DET_B)])
    ctl = det_controller(mesh)
    ctl.config = DictWrapper({
        "train_dataloader": lambda: DataLoader(samples, DET_B, shuffle=True, seed=5,
                                               num_workers=0),
        "val_dataloader": lambda: [[val]]})   # one loader of one batch
    fe = fe_controller(mesh)
    out = {"eval_fe": fe.run_eval_batch(fe.make_eval_step(), fe.init_state(
        0, "cpu", model=fe_wrapper(data["fe_sd"])), data["fe_batch"])}
    state = ctl.init_state(0, "cpu", model=detector("mask", data["mask_sd"]))
    out["eval_mask"] = ctl.run_eval_batch(ctl.make_eval_step(), state, val)
    trainer = Trainer(max_epochs=1, default_root_dir=root, device="cpu", mesh=mesh)
    saves = []
    save = trainer_module.save_checkpoint
    trainer_module.save_checkpoint = lambda *a: saves.append(save(*a)) or saves[-1]
    try:
        trainer.fit(ctl, state)
    finally:
        trainer_module.save_checkpoint = save
    out["fit_saves"] = len(saves)
    out["fit_validate"] = trainer.validate(ctl, state)
    out["fit_read"] = samples.read
    out["fit_state"] = {n: t.numpy().copy() for n, t in state.model.state_dict().items()}
    out["fit_checkpoints"] = sorted(p.name for p in (root / "checkpoints").iterdir())
    out["fit_checkpoint"] = {n: t.numpy() for n, t in load_checkpoint(
        root / "checkpoints" / out["fit_checkpoints"][-1])["model"].items()}
    return out


def fe_step(sd, batch, mesh=None) -> dict:
    ctl = fe_controller(mesh)
    state = ctl.init_state(0, "cpu", model=fe_wrapper(sd))
    metrics = ctl.train_step(state, parallel.shard_batch(batch, mesh))
    return {"metrics": metrics,
            "grads": {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()},
            "stats": {n: b.numpy().copy() for n, b in state.model.named_buffers()}}


def det_step(kind, sd, batch, noise, mesh=None) -> dict:
    ctl = det_controller(mesh)
    state = ctl.init_state(0, "cpu", model=detector(kind, sd))
    noise = None if noise is None else {k: torch.from_numpy(v) for k, v in
                                        parallel.shard_batch(noise, mesh).items()}
    metrics = ctl.train_step(state, parallel.shard_batch(batch, mesh), sampler_noise=noise)
    return {"metrics": metrics,
            "grads": {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()
                      if p.grad is not None}}


# -- the ranks ------------------------------------------------------------------

def one_rank(inputs: Path, outputs: Path) -> None:
    """The same steps and calls without a mesh, on the whole batch."""
    data = pickle.loads(Path(inputs).read_bytes())
    out = {"fe": fe_step(data["fe_sd"], data["fe_batch"])}
    for kind in ("mask", "keypoint"):
        out[kind] = det_step(kind, data[f"{kind}_sd"], data[f"{kind}_batch"],
                             data[f"{kind}_noise"])
    out["mask_drawn"] = det_step("mask", data["mask_sd"], data["mask_batch"], None)
    q, g = gallery()
    out["pairwise"] = retrieval.pairwise_card_scores(q, g, "cpu")
    out["serve"] = tuple(t.numpy() for t in service().embed_batch(*serve_images()))
    out.update(fit_and_eval(data, Path(outputs).parent / "fit_one"))
    Path(outputs).write_bytes(pickle.dumps(out))


def worker(rank: int, inputs: Path, outputs: Path) -> None:
    """One rank: join the group from the env names, run every step and call
    of the module docstring, and pickle the results."""
    import torch.distributed as dist

    assert parallel.init_distributed(device="cpu")
    mesh = parallel.create_mesh(device="cpu")
    assert (mesh.size, mesh.rank, dist.get_backend()) == (WORLD, rank, "gloo")
    data = pickle.loads(Path(inputs).read_bytes())
    out = {"device_info": parallel.device_info()}
    out["fe"] = fe_step(data["fe_sd"], data["fe_batch"], mesh)
    for kind in ("mask", "keypoint"):
        out[kind] = det_step(kind, data[f"{kind}_sd"], data[f"{kind}_batch"],
                             data[f"{kind}_noise"], mesh)
    out["mask_drawn"] = det_step("mask", data["mask_sd"], data["mask_batch"], None, mesh)

    # the mutations: each rank's own BatchNorm moments, each rank's own counts
    saved = parallel.global_moments, parallel.global_sum
    parallel.global_moments = lambda x, dims: (x.mean(dim=dims), (x * x).mean(dim=dims))
    out["fe_local_bn"] = fe_step(data["fe_sd"], data["fe_batch"], mesh)
    parallel.global_sum = lambda x: x * parallel.shards()    # each rank's own count
    for kind in ("mask", "keypoint"):
        step = det_step(kind, data[f"{kind}_sd"], data[f"{kind}_batch"], data[f"{kind}_noise"],
                        mesh)
        # the heads the counts normalise: what the test reads
        out[f"{kind}_local_counts"] = {"grads": {
            n: g for n, g in step["grads"].items() if "box_predictor" in n or f"{kind}_" in n}}
    parallel.global_moments, parallel.global_sum = saved

    q, g = gallery()
    out["topk"] = {k: retrieval.sharded_topk_scores(q, g, k, mesh)
                   for k in (10, 60)}
    out["pairwise"] = retrieval.pairwise_card_scores(q, g, "cpu", mesh)
    emb, valid = service(mesh).embed_batch(*serve_images())
    out["serve"] = (emb.numpy(), valid.numpy())
    try:
        service(mesh, batch_size=3)
    except ValueError as e:
        out["serve_error"] = str(e)
    out.update(fit_and_eval(data, Path(outputs).parent / "fit_mesh", mesh))
    if rank:   # the test reads rank 1's tensors only to hold them equal to rank 0's
        for step in ("fe", "mask", "keypoint", "mask_drawn"):
            for part in ("grads", "stats"):
                if part in out[step]:
                    out[step][part] = {n: _digest(v) for n, v in out[step][part].items()}
        for part in ("fit_state", "fit_checkpoint"):
            out[part] = {n: _digest(v) for n, v in out[part].items()}
        for k in [k for k in out if k.endswith(("_local_bn", "_local_counts"))]:
            del out[k]
    Path(outputs).write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


def _digest(a: np.ndarray) -> str:
    import hashlib

    return f"{a.dtype}{a.shape}" + hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


if __name__ == "__main__":
    if sys.argv[1] == "one":
        one_rank(Path(sys.argv[2]), Path(sys.argv[3]))
    else:
        worker(int(sys.argv[1]), Path(sys.argv[2]), Path(sys.argv[3]))
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from test_torch_port_fe_train import _rel  # noqa: E402
from test_torch_port_models import (ZERO_BY_CONSTRUCTION, jax_sampler_noise,  # noqa: E402
                                    randomize)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _sharded(tree, mesh: Mesh, spec):
    return jax.device_put(tree, NamedSharding(mesh, spec))


def _jax_fe(batch):
    """JAX's FE wrapper: its variables as the port's state dict, and a
    callable that runs its training forward and backward jitted over the
    batch sharded on 2 devices (one compile): the loss, the gradients and the
    new running statistics on the batch (what ``Controller(mesh=...)``'s
    step applies), and the gradients on three roundings of it."""
    from pets_face_recognition_tpu.losses import SoftmaxBasedMetricLearning as JWrapper
    from pets_face_recognition_tpu.models import embedder as j_embedder
    from pets_face_recognition_tpu.models import resnet as j_resnet

    mesh = _jax_mesh()
    j_model = JWrapper(model=j_embedder.EmbeddingModel(
        backbone=j_resnet.ResNet(stage_sizes=STAGES), embedding_dim=D), emb_size=D,
        num_classes=C, margin_type="arc", use_focal=True)
    x, labels = jnp.asarray(batch["x"]), jnp.asarray(batch["label"])
    variables = jax.tree.map(np.asarray, randomize(
        jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x, labels),
        np.random.RandomState(23)))

    @jax.jit
    def grad_fn(params, x, labels):
        def loss_fn(p):
            out, mutated = j_model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                         x, labels, train=True, mutable=["batch_stats"])
            return out["loss"], mutated["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def run() -> dict:
        params = _sharded(variables["params"], mesh, P())
        labels_s = _sharded(labels, mesh, P("data"))
        runs = [grad_fn(params, _sharded(x * (
            1 + jnp.asarray(np.random.RandomState(s).randn(*x.shape), jnp.float32) * r), mesh,
            P("data")), labels_s) for s, r in ((0, 0.0), (1, FE_INPUT_ROUNDING),
                                               (2, FE_INPUT_ROUNDING), (3, FE_INPUT_ROUNDING))]
        grads = [weights.fe_state_dict({"params": jax.device_get(g)}) for _, g in runs]
        (loss, stats), _ = runs[0]
        return {"grads": grads[0], "spread": grads[1:], "loss": float(loss),
                "stats": weights.fe_state_dict({"params": variables["params"],
                                                "batch_stats": jax.device_get(stats)})}

    return weights.fe_state_dict(variables), run


def _jax_det(kind: str, batch: dict):
    """JAX's R-CNN over ``resnet18(features_only, frozen_stats)`` with the dry
    run's budgets: its variables as the port's state dict, the sampler noise of
    its key, and a callable that runs the step with the batch sharded over 2
    devices (and on two roundings of the images): the losses and gradients."""
    from pets_face_recognition_tpu.engine.detector_controller import \
        DetectionController as JDetectionController
    from pets_face_recognition_tpu.losses import SumDetectionLoss
    from pets_face_recognition_tpu.models import fpn as j_fpn
    from pets_face_recognition_tpu.models import rcnn as j_rcnn
    from pets_face_recognition_tpu.models import resnet as j_resnet

    mesh = _jax_mesh()
    cfg = j_rcnn.RCNNConfig(num_classes=2, with_mask=kind == "mask",
                            num_keypoints=3 if kind == "keypoint" else 0, **BUDGETS)
    j_det = j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(
        backbone=j_resnet.resnet18(features_only=True, frozen_stats=True)), cfg=cfg)
    config = type("Config", (), {"model": lambda self: j_det,
                                 "loss": lambda self, c, m: SumDetectionLoss(model=m)})()
    ctl = JDetectionController(config)
    targets = ctl._targets_from_batch(batch)
    images = jnp.asarray(batch["images"])
    variables = jax.tree.map(np.asarray, randomize(jax.eval_shape(lambda: ctl.model_loss.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, images, targets,
        train=True)), np.random.RandomState(23)))
    key = jax.random.PRNGKey(9)

    @jax.jit
    def grad_fn(params, x, t):
        def loss_at(p):
            out = ctl.model_loss.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                       x, t, train=True, rngs={"sampler": key})
            return out["loss"], out
        return jax.value_and_grad(loss_at, has_aux=True)(params)

    def run() -> dict:
        params = _sharded(variables["params"], mesh, P())
        t_s = _sharded(targets, mesh, P("data"))
        runs = [grad_fn(params, _sharded(images * (1 + jnp.asarray(
            np.random.RandomState(s).randn(*images.shape), jnp.float32) * r), mesh, P("data")),
            t_s) for s, r in ((0, 0.0), (1, DET_INPUT_ROUNDING), (2, DET_INPUT_ROUNDING))]
        grads = [weights.detection_state_dict({"params": jax.device_get(g)["model"]})
                 for (_, _), g in runs]
        return {"out": {k: float(v) for k, v in runs[0][0][1].items()},
                "grads": grads[0], "spread": grads[1:]}

    noise = jax_sampler_noise(ctl.model_loss, variables, key, DET_B, N_ANCHORS,
                              BUDGETS["rpn_post_nms_top_n_train"] + G)
    sd = weights.detection_state_dict({k: v["model"] for k, v in variables.items()})
    return sd, {k: v.astype(np.float32) for k, v in noise.items()}, run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's sharded steps here; the two ranks, and one rank on the whole
    batch without a mesh, in subprocesses meanwhile; every result."""
    tmp = tmp_path_factory.mktemp("dp")
    fe_b = fe_batch()
    fe_sd, fe_run = _jax_fe(fe_b)
    data, runs = {"fe_sd": fe_sd, "fe_batch": fe_b}, {"fe": fe_run}
    for kind in ("mask", "keypoint"):
        batch = det_batch(kind)
        sd, noise, runs[kind] = _jax_det(kind, batch)
        data.update({f"{kind}_sd": sd, f"{kind}_batch": batch, f"{kind}_noise": noise})
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(data))
    port = _free_port()
    procs = []
    for rank in ("one", *map(str, range(WORLD))):
        env = {k: v for k, v in os.environ.items() if not k.startswith("PFR_")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(WORLD),
                   PROCESS_ID=rank)
        log = open(tmp / f"{rank}.log", "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), rank, str(inputs),
             str(tmp / f"{rank}.pkl")], env=env, cwd=tmp, stdout=log, stderr=log)))
    j = {k: run() for k, run in runs.items()}      # JAX's sharded steps meanwhile
    out = {}
    for rank, log, proc in procs:
        proc.wait(timeout=600)
        log.close()
        assert proc.returncode == 0, (tmp / f"{rank}.log").read_text()[-3000:]
        out[rank] = pickle.loads((tmp / f"{rank}.pkl").read_bytes())
        (tmp / f"{rank}.pkl").unlink()          # ~0.5 GB of gradients a process
    inputs.unlink()
    one, ranks = out["one"], [out[str(r)] for r in range(WORLD)]
    return {"jax": j, "one": one, "ranks": ranks}


def _worst(got: dict, want: dict) -> tuple[str, float]:
    errs = {n: _rel(got[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def test_ranks_agree_and_report_the_group(run):
    """Both ranks hold the same gradients and statistics after every step
    (bit for bit: the same all-reduced sums; rank 1 sends each tensor's
    SHA-256), and ``device_info`` reports the group."""
    r0, r1 = run["ranks"]
    for step in ("fe", "mask", "keypoint", "mask_drawn"):
        for part in ("grads", "stats"):
            got = {n: _digest(v) for n, v in r0[step].get(part, {}).items()}
            assert got == r1[step].get(part, {}), (step, part)
        assert r0[step]["metrics"] == r1[step]["metrics"]
    for rank, r in enumerate(run["ranks"]):
        info = r["device_info"]
        assert (info["process_index"], info["process_count"], info["global_device_count"],
                info["platform"]) == (rank, WORLD, WORLD, "cpu")


def test_fe_step_over_two_ranks_matches_jax_and_one_rank(run):
    """Gradients within max(1e-3, JAX's spread) of JAX's sharded step and of
    one rank (worst and median tensor); the loss 1e-4; the running
    statistics, moved over the whole batch, 1e-5 of JAX's; per-rank BatchNorm
    moments miss by more than 10x the bound."""
    j, got, one = run["jax"]["fe"], run["ranks"][0]["fe"], run["one"]["fe"]
    spreads = [[_rel(d[n], j["grads"][n]) for n in j["grads"]] for d in j["spread"]]
    worst_bound = max(1e-3, max(max(s) for s in spreads))
    median_bound = max(1e-3, max(float(np.median(s)) for s in spreads))
    for ref in (j["grads"], one["grads"]):
        assert sorted(got["grads"]) == sorted(ref)
        errs = [_rel(got["grads"][n], ref[n]) for n in ref]
        assert max(errs) <= worst_bound and np.median(errs) <= median_bound, \
            (max(errs), np.median(errs), worst_bound)
    assert abs(got["metrics"]["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"])
    assert abs(got["metrics"]["loss"] - one["metrics"]["loss"]) <= 1e-5 * abs(j["loss"])
    stats = {n: v for n, v in got["stats"].items() if n.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * 17       # the stem and 4 blocks with 4 norms each
    for ref in (j["stats"], one["stats"]):
        worst, err = _worst(stats, {n: ref[n] for n in stats})
        assert err <= 1e-5, (worst, err)
    local = [_rel(run["ranks"][0]["fe_local_bn"]["grads"][n], j["grads"][n]) for n in j["grads"]]
    assert np.median(local) > 10 * median_bound, np.median(local)


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
def test_detection_step_over_two_ranks_matches_jax_and_one_rank(run, kind):
    """Losses within 1e-4 of JAX's sharded step; gradients within 1e-5 of one
    rank and within 1e-3 of JAX (median; the worst within 1e-3 plus JAX's
    1e-7 spread); each rank's own counts (plain DDP) miss one rank's
    task-head gradients by more than 1e-2 and leave its box head within
    1e-5 (the ranks sample 16 RoIs an image alike)."""
    j, got, one = run["jax"][kind], run["ranks"][0][kind], run["one"][kind]
    for term, want in j["out"].items():
        assert abs(got["metrics"][term] - want) <= 1e-4 * max(abs(want), 1e-6), (term, want)
    assert sorted(got["grads"]) == sorted(j["grads"]) == sorted(one["grads"])
    # zero in exact arithmetic, rounding on every side (test_torch_port_models)
    for n in ZERO_BY_CONSTRUCTION:
        for g in (got["grads"], one["grads"], j["grads"]):
            assert n not in g or np.abs(g[n]).max() <= 1e-6, n
    names = [n for n in j["grads"] if n not in ZERO_BY_CONSTRUCTION]
    worst, err = _worst(got["grads"], {n: one["grads"][n] for n in names})
    assert err <= 1e-5, (worst, err)
    errs = {n: _rel(got["grads"][n], j["grads"][n]) for n in names}
    spread = max(_rel(d[n], j["grads"][n]) for d in j["spread"] for n in names)
    worst = max(errs, key=errs.get)
    assert np.median(list(errs.values())) <= 1e-3
    assert errs[worst] <= 1e-3 + spread, (worst, errs[worst], spread)
    # plain DDP: the box losses divide by the sampled RoIs, 16 an image on
    # either rank, so they agree; the foreground RoIs and the visible
    # keypoints differ between the ranks, so the task head misses
    local = run["ranks"][0][f"{kind}_local_counts"]["grads"]
    box = [n for n in one["grads"] if "box_predictor" in n]
    assert max(_rel(local[n], one["grads"][n]) for n in box) <= 1e-5
    head = [n for n in one["grads"] if f"{kind}_" in n]
    assert head and max(_rel(local[n], one["grads"][n]) for n in head) > 1e-2


def test_drawn_noise_takes_each_rank_its_rows(run):
    """A step that draws its sampler noise from the step's generator: over
    two ranks as one rank on the whole batch (1e-5)."""
    got, one = run["ranks"][0]["mask_drawn"], run["one"]["mask_drawn"]
    worst, err = _worst(got["grads"], one["grads"])
    assert err <= 1e-5, (worst, err)
    assert abs(got["metrics"]["loss"] - one["metrics"]["loss"]) <= 1e-5 * one["metrics"]["loss"]


@pytest.mark.parametrize("k", [10, 60])
def test_sharded_topk_scores_matches_jax_and_topk_rows(run, k):
    """101 gallery rows over 2 ranks, ties among them; ``k`` = 60 exceeds a
    shard (51): indices equal to JAX's and to a stable top-k of the one-rank
    scores (``topk_rows``' order), scores within 1e-6."""
    from pets_face_recognition_tpu.retrieval import sharded_topk_scores as j_topk

    q, g = gallery()
    want_s, want_i = j_topk(q, g, k, _jax_mesh())
    scores = run["one"]["pairwise"]
    names = [f"g{i}" for i in range(GALLERY)]
    for r in run["ranks"]:
        got_s, got_i = r["topk"][k]
        assert got_i.shape == (QUERIES, k)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=0, atol=1e-6)
        for row, s, i in zip(retrieval.topk_rows(scores, np.ones_like(scores, bool), names, k),
                             scores, got_i):
            np.testing.assert_array_equal(i, np.argsort(-s, kind="stable")[:k])
            assert row[3] == ",".join(names[t] for t in i)
    assert (np.asarray(want_i)[0, :4] == [3, 10, 60, 99]).all()


def test_pairwise_scores_and_serving_over_the_mesh_match_one_rank(run):
    """The mesh's ``pairwise_card_scores`` equal one rank's; each rank's
    ``embed_batch`` returns the whole batch, rows within 1e-5 of one rank's
    and validity equal; ``batch_size`` 3 over 2 ranks raises."""
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["pairwise"], run["one"]["pairwise"])
        emb, valid = r["serve"]
        want_emb, want_valid = run["one"]["serve"]
        assert emb.shape == want_emb.shape == (4, 512)
        np.testing.assert_array_equal(valid, want_valid)
        assert np.abs(emb - want_emb).max() <= 1e-5 * np.abs(want_emb).max()
        assert r["serve_error"] == "batch_size 3 not divisible by data axis 2"


def test_fit_and_eval_over_two_ranks_match_one_rank(run):
    """``Trainer.fit`` over the mesh: each rank's loader reads only its rows
    of every global batch (half of one rank's reads; together the same
    samples), only rank 0 saves, and its one checkpoint holds weights within
    1e-6 of one rank's (relative in norm, the worst tensor; a detection
    step's gradients are held to 1e-5); both ranks end with the same weights
    bit for bit, and ``validate`` gives the same metrics on both ranks,
    within 1e-6 of one rank's. ``run_eval_batch`` of the FE and the Mask
    R-CNN controllers gathers every rank's rows in rank order: the
    embeddings and the detections, pasted masks included, within 1e-5 of
    the largest value of one rank's (validity and labels equal)."""
    one, (r0, r1) = run["one"], run["ranks"]
    assert sorted(r0["fit_read"] + r1["fit_read"]) == sorted(one["fit_read"])
    assert len(r0["fit_read"]) == len(r1["fit_read"]) == len(one["fit_read"]) // 2
    assert (r0["fit_saves"], r1["fit_saves"], one["fit_saves"]) == (1, 0, 1)
    assert r0["fit_checkpoints"] == r1["fit_checkpoints"] == one["fit_checkpoints"] \
        == ["epoch=0-step=2"]
    for part in ("fit_state", "fit_checkpoint"):
        assert {n: _digest(v) for n, v in r0[part].items()} == r1[part]
    ckpt = r0["fit_checkpoint"]
    worst, err = _worst({n: v for n, v in ckpt.items() if v.dtype.kind == "f"},
                        {n: v for n, v in one["fit_checkpoint"].items() if v.dtype.kind == "f"})
    assert err <= 1e-6, (worst, err)
    assert r0["fit_validate"] == r1["fit_validate"]
    for name, metrics in one["fit_validate"].items():
        for k, v in metrics.items():
            assert abs(r0["fit_validate"][name][k] - v) <= 1e-6, (name, k)
    for r in (r0, r1):
        got, want = r["eval_fe"], one["eval_fe"]
        assert got["emb"].shape == want["emb"].shape == (FE_B, D)
        assert np.abs(got["emb"] - want["emb"]).max() <= 1e-5 * np.abs(want["emb"]).max()
        np.testing.assert_array_equal(got["index"], want["index"])
        got, want = r["eval_mask"]["pred"], one["eval_mask"]["pred"]
        assert sorted(got) == sorted(want) and want["masks"].shape == (DET_B, 2, DET_IMG,
                                                                       DET_IMG)
        for k, v in want.items():
            if v.dtype.kind == "f":
                assert np.abs(got[k] - v).max() <= 1e-5 * max(np.abs(v).max(), 1.0), k
            else:
                np.testing.assert_array_equal(got[k], v)


def test_world_of_one_and_shard_batch():
    """No env names: no group, a one-rank mesh whose collectives are the
    identity; ``device_info`` has JAX's keys; ``shard_batch`` takes
    contiguous rows and raises on a batch that does not split, as JAX's
    sharded ``device_put`` does."""
    from pets_face_recognition_tpu.parallel import device_info as j_device_info
    from pets_face_recognition_tpu.parallel import shard_batch as j_shard_batch

    env = {k: os.environ.pop(k) for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
           if k in os.environ}
    try:
        assert parallel.init_distributed(device="cpu") is False
        info = parallel.device_info()
        assert sorted(info) == sorted(j_device_info())
        assert (info["process_index"], info["process_count"], info["platform"]) == (0, 1, "cpu")
        mesh = parallel.create_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.group, mesh.shape) == (1, 0, None, {"data": 1})
        x = torch.arange(6.0)
        assert parallel.all_gather_rows(x, mesh) is x
        with pytest.raises(ValueError, match="'model' axis"):
            parallel.create_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        os.environ.update(env)
    two = parallel.Mesh(size=2, rank=1)
    batch = {"x": np.arange(8).reshape(4, 2), "y": [torch.arange(4), np.arange(4)]}
    got = parallel.shard_batch(batch, two)
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["y"][0].tolist() == [2, 3] and got["y"][1].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch({"x": np.zeros((3, 2))}, two)
    loader = DataLoader(list(range(10)), 4, num_workers=0)
    assert [b.tolist() for b in loader.shard(1, 2)] == [[2, 3], [6, 7], [9]]
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(list(range(9)), 3, num_workers=0).shard(0, 2)
    with pytest.raises(ValueError):
        j_shard_batch({"x": np.zeros((3, 2))}, _jax_mesh())
