"""The retrieval chain from a trained keypoint detector's checkpoint, and the
service's crop size and landmark rule, against the JAX package on the CPU.

``generate_tsv`` with ``PFR_KEYPOINT_CKPT`` naming a port checkpoint runs
against the JAX head chain (``configs/retrieval_common.build_pipelines``
with ``PFR_KEYPOINT_CKPT`` naming an orbax checkpoint of the same random
variables, carried over by ``weights.detection_state_dict``), over two cards
of each folder of the committed corpus. Both detectors are cut to one block
a stage at the production widths and run at ``RCNNConfig``'s test budgets of
1000 and 1000 with one detection, as the JAX chain builds its detector. The
embedders are the same stand-in on both sides: a unit vector of four
+-1/2 entries among 16 coordinates, drawn from the crop's mean pixel in
half-level bins (the two crops' means agree to ~1e-4 of a level). The
detector decides which photos keep a vector and where the crop lies, so
the tsv, written as bytes by both chains, shows it; the scores are exact in
float32, so the bytes can be compared.
"""

import functools
import importlib
import importlib.util
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from torch import nn

from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.serving import EmbeddingService as JEmbeddingService
from pets_face_recognition_tpu_torch import generate_tsv, pipelines, serving, weights
from pets_face_recognition_tpu_torch.models import rcnn as p_rcnn
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.serving import EmbeddingService

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CORPUS = REPO / "pets_face_recognition_tpu_torch" / "testdata" / "kashtanka_test"
_spec = importlib.util.spec_from_file_location("_pfr_retrieval_common",
                                               REPO / "configs" / "retrieval_common.py")
retrieval_common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(retrieval_common)
j_generate = importlib.import_module("generate_tsv_to_reproduce1")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
FE_CKPTS = {k: (f"PFR_{k.upper()}_FE_CKPT", f"results/{k}/checkpoints")
            for k in ("cat_head", "dog_head", "cat_body", "dog_body")}


def exact_vector(x: np.ndarray, salt: int) -> np.ndarray:
    """A unit vector of four +-1/2 entries among 16 coordinates from the
    crop's mean pixel (on the 0-255 scale) in half-level bins, per embedder;
    a crop with NaNs (a degenerate map, on both sides) has a bin of its
    own."""
    mean = float(np.mean(x, dtype=np.float64))
    b = int(np.floor(mean * 510.0)) if np.isfinite(mean) else -1
    rng = np.random.RandomState((b * 7 + salt) % (2 ** 31))
    v = np.zeros(512, np.float32)
    v[rng.choice(16, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return v


class ExactEmbedder(nn.Module):
    def __init__(self, salt: int):
        super().__init__()
        self.salt = salt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(exact_vector(x.numpy(), self.salt))[None]


def narrow_jax_detector(num_classes=2, num_keypoints=3, box_detections_per_img=1, quant=None,
                        quant_scope="rpn", quant_kp=None, **overrides):
    """JAX's ``keypointrcnn_resnet50_fpn`` with one block a stage."""
    assert quant is None and quant_kp is None
    cfg = j_rcnn.RCNNConfig(num_classes=num_classes, num_keypoints=num_keypoints,
                            box_detections_per_img=box_detections_per_img, **overrides)
    return j_rcnn.GeneralizedRCNN(backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
        stage_sizes=STAGES, features_only=True, frozen_stats=True)), cfg=cfg)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One set of random detector variables as a JAX orbax checkpoint (params
    and batch_stats under ``model``, as training wraps them) and as a port
    checkpoint, and a split of two cards of each corpus folder, one photo a
    card. These variables keep 7 of the 8 photos (one query's fails the
    landmark rule) and rank 3 queries."""
    root = tmp_path_factory.mktemp("chain_ckpt")
    variables = randomize(jax.eval_shape(narrow_jax_detector().init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 320, 320, 3))), np.random.RandomState(42))
    j_dir, p_dir = root / "jax" / "checkpoints", root / "port" / "checkpoints"
    j_dir.mkdir(parents=True)
    p_dir.mkdir(parents=True)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((j_dir / "epoch=0-step=5").resolve(),
                   {"params": {"model": variables["params"]},
                    "batch_stats": {"model": variables["batch_stats"]},
                    "opt_state": {"mu": np.zeros(2)}, "step": 5, "epoch": 0}, force=True)
    sd = {k: t.float() for k, t in weights.to_tensors(
        weights.detection_state_dict(variables)).items()}
    torch.save({"model": sd, "optimizer": {}, "accum": None, "step": 5, "epoch": 0},
               p_dir / "epoch=0-step=5")
    data = root / "split"
    for side in ("found", "lost"):
        for sub in (side, f"extra_{side}"):
            for card in sorted((CORPUS / side / sub).iterdir())[:2]:
                dst = data / side / sub / card.name
                dst.mkdir(parents=True)
                shutil.copy(card / "card.json", dst / "card.json")
                shutil.copy(card / "0.jpg", dst / "0.jpg")
    return dict(j_dir=j_dir, p_dir=p_dir, sd=sd, data=data, root=root)


@pytest.fixture
def narrow_port(monkeypatch):
    """The port's factories as the test cuts them: the ResNet-50-FPN detector
    one block a stage (its budgets the factory's), the embedders the
    stand-ins."""
    monkeypatch.setattr(p_rcnn, "keypointrcnn_resnet50_fpn", functools.partial(
        p_rcnn.keypointrcnn_resnet50_fpn, stage_sizes=STAGES))
    monkeypatch.setattr(pipelines, "embedder", lambda name, seed, device="cuda",
                        dtype=torch.float32: ExactEmbedder({"fe_dog_head": 1,
                                                            "fe_cat_head": 2}[name]))
    monkeypatch.delenv("PFR_KEYPOINT_ARCH", raising=False)
    monkeypatch.delenv("PFR_QUANT_MODE", raising=False)
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")


@pytest.fixture(scope="module")
def jax_tsv(ckpts):
    """The JAX head chain over the split: ``build_pipelines`` (its detector
    from ``PFR_KEYPOINT_CKPT``), the reproduce script's walk, score table and
    pandas writer."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(retrieval_common.pipelines, "keypointrcnn_resnet50_fpn", narrow_jax_detector)
        salts = {"fe_dog_head": 1, "fe_cat_head": 2, "fe_dog_body": 3, "fe_cat_body": 4}
        mp.setattr(retrieval_common, "_embedder_fn", lambda name, env, default, input_hw=224: (
            lambda x: exact_vector(np.asarray(x), salts[name])[None]))
        mp.setenv("PFR_KEYPOINT_CKPT", str(ckpts["j_dir"]))
        mp.setenv("PFR_RETRIEVAL_THR", "0.0")
        mp.delenv("PFR_KEYPOINT_ARCH", raising=False)
        mp.delenv("PFR_QUANT_MODE", raising=False)
        mp.delenv("PFR_SCORES_DUMP", raising=False)
        head, _ = retrieval_common.build_pipelines(FE_CKPTS)
        db = j_generate.prepare_data(ckpts["data"].resolve(), head, None)
        jr._SCORES_DUMP.clear()
        out = ckpts["root"] / "jax.tsv"
        jr.write_tsv(jr.create_table(db), out)
    finally:
        mp.undo()
    return out


def test_generate_tsv_from_a_keypoint_checkpoint_writes_the_jax_chains_tsv(
        ckpts, jax_tsv, narrow_port, monkeypatch, tmp_path):
    """The same bytes as the JAX chain's tsv, with at least three queries
    ranked; the run built its detector from the checkpoint."""
    monkeypatch.setenv("PFR_KEYPOINT_CKPT", str(ckpts["p_dir"]))
    out = tmp_path / "pred.tsv"
    assert generate_tsv.main(["--data", str(ckpts["data"]), "--output", str(out),
                              "--stock-preds", str(tmp_path / "none.tsv"), "--device",
                              "cpu"]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) >= 4 and lines[0] == "query\tmatched_1\tmatched_3\tmatched_10\tanswer"
    assert out.read_bytes() == jax_tsv.read_bytes()


def test_the_chains_detector_is_the_checkpoints(ckpts, narrow_port, monkeypatch):
    """``build_retrieval_models`` loads ``PFR_KEYPOINT_CKPT`` (a folder gives
    its newest checkpoint) at 1000 / 1000 proposals and one detection."""
    monkeypatch.setenv("PFR_KEYPOINT_CKPT", str(ckpts["p_dir"]))
    det, _, _ = pipelines.build_retrieval_models("cpu", 0)
    got = det.state_dict()
    assert set(got) == set(ckpts["sd"])
    for k, t in ckpts["sd"].items():
        assert torch.equal(got[k], t), k
    cfg = det.cfg
    assert (cfg.rpn_pre_nms_top_n_test, cfg.rpn_post_nms_top_n_test,
            cfg.box_detections_per_img) == (1000, 1000, 1)
    assert not det.training


def test_a_variable_that_names_nothing_raises(narrow_port, monkeypatch, tmp_path):
    monkeypatch.setenv("PFR_KEYPOINT_CKPT", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="PFR_KEYPOINT_CKPT"):
        pipelines.build_retrieval_models("cpu", 0)
    with pytest.raises(FileNotFoundError, match="PFR_KEYPOINT_CKPT"):
        generate_tsv.main(["--data", str(CORPUS), "--output", str(tmp_path / "x.tsv"),
                           "--device", "cpu"])
    assert not (tmp_path / "x.tsv").exists()


def test_no_variable_keeps_the_seeded_serving_detector(narrow_port, monkeypatch, capsys):
    """Without the variable (and no checkpoint at the default) the chain's
    detector is the seeded serving detector at 128 / 16, as before, and says
    so."""
    monkeypatch.delenv("PFR_KEYPOINT_CKPT", raising=False)
    monkeypatch.delenv("PFR_QUANT_MODE", raising=False)
    monkeypatch.chdir(REPO)
    det, _, _ = pipelines.build_retrieval_models("cpu", 3)
    assert "no keypoint checkpoint at results/keypoint/checkpoints" in capsys.readouterr().out
    want = serving.serving_detector("cpu", 3)
    assert (det.cfg.rpn_pre_nms_top_n_test, det.cfg.rpn_post_nms_top_n_test) == (128, 16)
    for k, t in want.state_dict().items():
        assert torch.equal(det.state_dict()[k], t), k


@pytest.fixture(scope="module")
def service_models():
    """A cut detector (one block a stage, budgets 32 / 8) and embedder on one
    set of random variables, both sides."""
    rng = np.random.RandomState(33)
    j_det = narrow_jax_detector(rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=8)
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 128, 128, 3))), rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    emb_vars = randomize(jax.eval_shape(j_emb.init, jax.random.PRNGKey(1),
                                        jnp.zeros((1, 224, 224, 3))), rng)
    det = p_rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=32,
                                           rpn_post_nms_top_n_test=8)
    det.load_state_dict(weights.to_tensors(weights.detection_state_dict(det_vars)))
    emb = resnet50_embedder(512, stage_sizes=STAGES)
    emb.load_state_dict(weights.to_tensors(weights.embedder_state_dict(emb_vars)))
    images = rng.randint(0, 256, (4, 128, 128, 3)).astype(np.uint8)
    j_dets = jax.jit(lambda x: j_det.apply(det_vars, x))(jnp.asarray(images, jnp.float32) / 255)
    kps = np.round(np.asarray(j_dets["keypoints"])[:, 0, :, :2])
    dists = np.stack([np.linalg.norm(kps[:, a] - kps[:, b], axis=-1)
                      for a, b in ((0, 1), (0, 2), (1, 2))]).min(0)
    e1, e2 = kps[:, 1] - kps[:, 0], kps[:, 2] - kps[:, 0]
    areas = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) / 2
    return dict(j_det=j_det, det_vars=det_vars, j_emb=j_emb, emb_vars=emb_vars,
                det=det.eval(), emb=emb.eval(), images=images, dists=dists, areas=areas)


@pytest.mark.parametrize("rule,crop_size", [("zero", (160, 192)), ("between", (224, 224))])
def test_service_crop_size_and_min_distance_match_jax(service_models, rule, crop_size):
    """``EmbeddingService(crop_size=..., min_distance=...)`` against JAX's at
    float32: validity equal and equal to the rule on JAX's rounded
    landmarks, at 0 (every row kept) and between the images' closest
    landmark pairs (some rows kept, others dropped); embeddings within 5e-3
    relative on rows valid on both sides (the slice test's bound: crops
    ~1e-3 apart through a chain of float32 convolutions) whose landmark
    triangle spans at least 50 px². A random detector also gives nearly
    collinear landmarks (here a 6 px² triangle with sides over 5 px): the
    homography is then ill-conditioned, each side's float32 solve maps it
    elsewhere, and the embeddings differ by ~0.24 relative."""
    m = service_models
    d = np.sort(m["dists"])
    min_distance = {"zero": 0.0, "between": float((d[1] + d[2]) / 2)}[rule]
    ok = np.ones(len(m["images"]), bool)
    kw = dict(crop_size=crop_size, min_distance=min_distance, score_thr=0.0)
    j_svc = JEmbeddingService(lambda x: m["j_det"].apply(m["det_vars"], x),
                              lambda c: m["j_emb"].apply(m["emb_vars"], c),
                              batch_size=len(ok), input_size=(128, 128),
                              warp_dtype=jnp.float32, **kw)
    want_e, want_v = (np.asarray(t) for t in j_svc._embed(jnp.asarray(m["images"]),
                                                          jnp.asarray(ok)))
    svc = EmbeddingService(m["det"], m["emb"], device="cpu", input_size=(128, 128), **kw)
    assert (svc.crop_size, svc.min_distance) == (crop_size, min_distance)
    got_e, got_v = svc.embed_batch(torch.from_numpy(m["images"]), torch.from_numpy(ok))
    assert got_e.shape == want_e.shape == (len(ok), 512)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(want_v, m["dists"] > min_distance)
    assert 0 < want_v.sum() < len(ok) if rule == "between" else want_v.all()
    rows = want_v & (m["areas"] >= 50.0)
    assert rows.any()
    err = np.abs(got_e.numpy()[rows] - want_e[rows]).max() / np.abs(want_e[rows]).max()
    assert err < 5e-3
