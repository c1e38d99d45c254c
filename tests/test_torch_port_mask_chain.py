"""The port's head+body retrieval (``generate_tsv --body``) against the JAX
package's ``generate_tsv_to_reproduce1.py`` on the CPU.

Three checks: the ensemble tsv, byte for byte, from the same embeddings
through both walks (``prepare_data``: each photo through the head pipeline,
then the body pipeline), both score tables and both writers; the body
pipeline (``Preproc4`` box crop, uint8, ``resize_with_padding`` to 256, the
body embedder) against a JAX body pipeline built the way
``configs/retrieval_common.py`` builds it, on one set of weights (Mask R-CNN
and the embedders cut to one block a stage at production widths); and the
entry point end to end.

The same embeddings: each photo's vectors are made from its pixels, with
four entries of +-1/2 among 16 coordinates, so that every norm is 1 and
every dot product and card mean is exact in float32 whatever the order of
the sums; the two frameworks' score products then agree bit for bit, and
the tsvs can be compared as bytes (ties included).
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import fpn as j_fpn
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.preprocessor import Preproc4 as JPreproc4
from pets_face_recognition_tpu.utils.preprocs import resize_with_padding as j_resize_with_padding
from pets_face_recognition_tpu_torch import generate_tsv, pipelines, retrieval, weights
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.rcnn import (keypointrcnn_resnet50_fpn,
                                                         maskrcnn_resnet50_fpn)

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
j_generate = importlib.import_module("generate_tsv_to_reproduce1")
make_smoke_datasets = importlib.import_module("make_smoke_datasets")

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
PRE, POST = 64, 32


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("kashtanka")
    return make_smoke_datasets.make_kashtanka_test(root, n_pairs=4, n_extra=3, n_imgs=2)


def exact_vector(img: np.ndarray, salt: int) -> np.ndarray | None:
    """A unit vector of four +-1/2 entries among 16 coordinates, from the
    photo's pixels; ``None`` for about a quarter of the photos (the
    pipeline's failure), different ones for ``salt`` 1 (head) and 2 (body)."""
    rng = np.random.RandomState((int(img.astype(np.int64).sum()) * 7 + salt) % (2 ** 31))
    if rng.rand() < 0.25:
        return None
    v = np.zeros(512, np.float32)
    v[rng.choice(16, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return v


def test_ensemble_tsv_is_byte_equal_to_jax(split, tmp_path):
    """The same cards, vectors and ensemble scores, and the same tsv bytes
    as the JAX script's walk, ``create_table`` and pandas writer, with some
    cards holding body vectors alone (the rule's body fallback)."""
    head = lambda img, t: exact_vector(img, 1)     # noqa: E731
    body = lambda img, t: exact_vector(img, 2)     # noqa: E731
    j_db = j_generate.prepare_data(split, head, body)
    db = generate_tsv.prepare_data(split, head, body_pipeline=body)
    assert list(db) == list(j_db)
    n_body_only = 0
    for key in db:
        for got, want in zip(db[key], j_db[key]):
            assert [c.name for c in got] == [c.name for c in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.head_vectors.reshape(-1, 512) if g.has_head
                                              else np.zeros((0, 512)),
                                              w.head_vectors.reshape(-1, 512) if w.has_head
                                              else np.zeros((0, 512)))
                np.testing.assert_array_equal(g.body_vectors, w.body_vectors)
                n_body_only += int(g.has_body and not g.has_head)
    assert n_body_only > 0, "no card exercises the body fallback"
    jr._SCORES_DUMP.clear()
    j_rows = jr.create_table(j_db)
    jr.write_tsv(j_rows, tmp_path / "jax.tsv")
    rows = retrieval.create_table(db, "cpu")
    retrieval.write_tsv(rows, tmp_path / "port.tsv")
    assert len(rows) >= 4
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


@pytest.fixture(scope="module")
def body_models():
    rng = np.random.RandomState(51)
    j_det = j_rcnn.GeneralizedRCNN(
        backbone=j_fpn.BackboneWithFPN(backbone=j_resnet.ResNet(
            stage_sizes=STAGES, features_only=True, frozen_stats=True)),
        cfg=j_rcnn.RCNNConfig(num_classes=2, with_mask=True, box_detections_per_img=3,
                              rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST))
    det_vars = randomize(jax.eval_shape(j_det.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 320, 320, 3))), rng)
    j_emb = j_embedder.EmbeddingModel(backbone=j_resnet.ResNet(stage_sizes=STAGES))
    emb_shape = jax.eval_shape(j_emb.init, jax.random.PRNGKey(1), jnp.zeros((1, 256, 256, 3)))
    dog_vars, cat_vars = randomize(emb_shape, rng), randomize(emb_shape, rng)
    det = maskrcnn_resnet50_fpn(stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE,
                                rpn_post_nms_top_n_test=POST)
    dog = resnet50_embedder(512, stage_sizes=STAGES)
    cat = resnet50_embedder(512, stage_sizes=STAGES)
    for module, sd in zip((det, dog, cat),
                          weights.retrieval_state_dicts(det_vars, dog_vars, cat_vars)):
        module.load_state_dict(sd, strict=True)
    j_fes = {t: jax.jit(lambda x, v=v: j_emb.apply(v, x)) for t, v in ((1, dog_vars),
                                                                         (2, cat_vars))}
    return dict(j_det=jax.jit(lambda x: j_det.apply(det_vars, x)), j_fes=j_fes,
                det=det.eval(), dog=dog.eval(), cat=cat.eval())


def test_body_pipeline_matches_jax(split, body_models, monkeypatch):
    """``build_body_pipeline`` against the JAX body pipeline on each photo of
    the split (320 x 320, so both letterboxes are exact): the same photos
    kept, the same 256 x 256 letterboxed crop, embeddings within 1e-4
    relative (a chain of float32 convolutions)."""
    j4 = JPreproc4(model_fn=body_models["j_det"], thr=0.0)

    def j_body(img, animal_type):
        try:
            crop = j4(img)
        except (AssertionError, ValueError, OSError):
            return None, None
        padded = np.asarray(j_resize_with_padding(Image.fromarray(crop.astype(np.uint8)),
                                                  (256, 256)))
        x = jnp.asarray(padded[None], jnp.float32) / 255.0
        return padded, np.asarray(body_models["j_fes"][animal_type](x))[0]

    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    body = pipelines.build_body_pipeline(body_models["det"], body_models["dog"],
                                         body_models["cat"], device="cpu")
    seen = []
    real = pipelines.resize_with_padding
    monkeypatch.setattr(pipelines, "resize_with_padding",
                        lambda c, s: seen.append(real(c, s)) or seen[-1])
    n = 0
    for i, p in enumerate(sorted(split.rglob("*.jpg"))[:6]):
        img = generate_tsv.read_image(p)
        animal = 1 + i % 2
        want_crop, want = j_body(img, animal)
        got = body(img, animal)
        assert (got is None) == (want is None)
        if want is None:
            continue
        np.testing.assert_array_equal(seen[-1], want_crop)
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
        n += 1
    assert n >= 4


def test_generate_tsv_body_main(body_models, tmp_path, monkeypatch):
    """``generate_tsv --body`` end to end on the CPU with one-block models
    over a small split: the default output ``pred_scores_test1.tsv``, the JAX
    header, and the rows of the walk it made (body vectors in it)."""
    split = make_smoke_datasets.make_kashtanka_test(tmp_path / "data", n_pairs=2, n_extra=1,
                                                    n_imgs=1)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    kp = weights.init_random_(keypointrcnn_resnet50_fpn(
        stage_sizes=STAGES, rpn_pre_nms_top_n_test=PRE, rpn_post_nms_top_n_test=POST), 0).eval()
    head_emb = [weights.init_random_(resnet50_embedder(512, stage_sizes=STAGES), s).eval()
                for s in (1, 2)]
    models = (kp, *head_emb, body_models["det"], body_models["dog"], body_models["cat"])
    calls, dbs = [], []

    def build(dev, seed, arch, body=False):
        calls.append(body)
        return models if body else models[:3]

    real = generate_tsv.prepare_data
    monkeypatch.setattr(generate_tsv, "build_retrieval_models", build)
    monkeypatch.setattr(generate_tsv, "prepare_data",
                        lambda *a, **k: dbs.append(real(*a, **k)) or dbs[-1])
    assert generate_tsv.main(["--data", str(split), "--body", "--device", "cpu"]) == 0
    assert calls == [True]
    lines = (tmp_path / "pred_scores_test1.tsv").read_text().splitlines()
    assert lines[0] == "query\tmatched_1\tmatched_3\tmatched_10\tanswer"
    assert any(c.has_body for q, g in dbs[0].values() for c in q + g)
    retrieval.write_tsv(retrieval.create_table(dbs[0], "cpu"), tmp_path / "again.tsv")
    assert (tmp_path / "again.tsv").read_text().splitlines() == lines
    assert len(lines) >= 2
