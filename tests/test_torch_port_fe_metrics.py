"""The feature extractor's metrics in the port (``engine/metrics.py``,
``Controller.evaluate``) against scikit-learn and the JAX package on the CPU.

- ``roc_curve`` (intermediate points dropped, the leading ``inf``),
  ``roc_auc_score`` and the average precision: bit-equal to scikit-learn
  1.9's on random cases with many tied scores;
- ``verification_metrics``, ``recall_at_k`` (ties broken towards the lower
  index, as ``lax.top_k``), ``cosine_pair_scores`` (1e-6) and the FE
  ``Controller.evaluate`` over a pair generator: equal to JAX's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score, roc_curve

from pets_face_recognition_tpu.engine import metrics as j_metrics
from pets_face_recognition_tpu.engine.controller import Controller as JController
from pets_face_recognition_tpu_torch.engine import metrics
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.utils import DictWrapper

torch.set_num_threads(1)


def cases(seed, n_cases=60):
    rng = np.random.RandomState(seed)
    for _ in range(n_cases):
        n = rng.randint(2, 80)
        labels = rng.randint(0, 2, n)
        if len(np.unique(labels)) < 2:
            labels[0] = 1 - labels[-1]
        if rng.rand() < 0.5:      # few distinct values: long runs of ties
            scores = rng.randint(0, rng.randint(1, 10), n) / 9.0
        else:
            scores = rng.rand(n)
        yield labels, scores


@pytest.mark.parametrize("seed", range(8))
def test_roc_auc_and_ap_bit_equal_to_sklearn(seed):
    for labels, scores in cases(seed):
        want = roc_curve(labels, scores)
        got = metrics.roc_curve(labels, scores)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert metrics.roc_auc_score(labels, scores) == roc_auc_score(labels, scores)
        assert max(0.0, metrics.average_precision(labels, scores)) == \
            average_precision_score(labels, scores)


def test_one_class_auc_is_nan_and_nonfinite_scores_raise():
    assert np.isnan(metrics.roc_auc_score(np.ones(4), np.arange(4.0)))
    with pytest.raises(ValueError):
        metrics.roc_curve(np.array([0, 1]), np.array([0.5, np.nan]))


VERIFICATION_KW = dict(thrs=tuple(np.linspace(0.5, 0.99, 6)),
                       far_thrs=(0.1, 0.05, 0.03, 0.01, 0.005, 0.001), frr_thrs=(0.1, 0.01))


@pytest.mark.parametrize("seed", range(4))
def test_verification_metrics_equal_jax(seed):
    """The whole dict, keys in order and values equal, with ties in the
    scores (the optimal threshold is the argmin over the dropped ROC curve)."""
    for labels, scores in cases(100 + seed, 15):
        want = j_metrics.verification_metrics(scores, labels, **VERIFICATION_KW)
        got = metrics.verification_metrics(scores, labels, **VERIFICATION_KW)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


@pytest.mark.parametrize("seed", range(3))
def test_recall_at_k_equals_jax_with_ties(seed):
    """Duplicated embeddings make exact ties in the similarity rows; the
    top-k takes the lower index first on both sides."""
    rng = np.random.RandomState(seed)
    base = rng.randn(12, 16).astype(np.float32)
    emb = base[rng.randint(0, 12, 40)]                      # many exact duplicates
    classes = rng.randint(0, 6, 40)
    for ks in ((1, 5, 10), (5, 10, 100), (1,)):
        want = j_metrics.recall_at_k(jnp.asarray(emb), jnp.asarray(classes), ks)
        got = metrics.recall_at_k(emb, classes, ks)
        assert got == want
        assert metrics.recall_at_k(torch.from_numpy(emb), torch.from_numpy(classes), ks) == want
    assert metrics.recall_at_k(emb, classes, ()) == {}


def test_cosine_pair_scores_match_jax():
    rng = np.random.RandomState(7)
    emb = rng.randn(30, 64).astype(np.float32)
    pairs = rng.randint(0, 30, (100, 2))
    want = np.asarray(j_metrics.cosine_pair_scores(jnp.asarray(emb), pairs))
    got = metrics.cosine_pair_scores(torch.from_numpy(emb), pairs).numpy()
    assert np.abs(got - want).max() <= 1e-6


class _Pairs:
    def __init__(self, rng, n):
        pairs = rng.randint(0, n, (200, 2))
        self.labels = rng.randint(0, 2, 200)
        self.corrected_indices = [tuple(p) for p in pairs]


def test_controller_evaluate_equals_jax(tmp_path):
    """``evaluate`` over two shuffled eval batches: the embeddings sorted by
    index, the pairs' scores, the verification metrics and Recall@K against
    the JAX ``Controller.evaluate``, within 1e-6 (the thresholds are pair
    scores, which the two frameworks round apart in the last float32 bit);
    ``img_dir`` gets the confusion counts at ``Opt thr`` and the ROC points as
    JSON."""
    rng = np.random.RandomState(11)
    n = 50
    emb = rng.randn(n, 32).astype(np.float32)
    classes = rng.randint(0, 10, n)
    order = rng.permutation(n)
    batches = [{"emb": emb[order[:30]], "label": classes[order[:30]], "index": order[:30]},
               {"emb": emb[order[30:]], "label": classes[order[30:]], "index": order[30:]}]
    gen = _Pairs(rng, n)
    knobs = dict(thrs=np.linspace(0.5, 0.99, 6), far_thr=[0.1, 0.05, 0.01], k=[1, 5, 10],
                 pair_generator=lambda i: ("Val", gen))
    j_cfg = DictWrapper(dict(knobs, model=lambda: None, loss=lambda c, m: None))
    want = JController(j_cfg).evaluate([batches])
    cfg = DictWrapper(dict(knobs, img_dir=tmp_path / "img"))
    got = Controller(cfg).evaluate([batches])
    assert list(got) == list(want) == ["Val"]
    assert list(got["Val"]) == list(want["Val"])
    for k, v in want["Val"].items():
        assert abs(got["Val"][k] - v) <= 1e-6, k
    dump = json.loads((tmp_path / "img" / "eval_0.json").read_text())["Val"]
    scores = metrics.cosine_pair_scores(torch.from_numpy(emb),
                                        np.asarray(gen.corrected_indices)).numpy()
    pred = scores > dump["opt_thr"]
    assert dump["confusion"]["tp"] == int((pred & (gen.labels == 1)).sum())
    assert dump["confusion"]["tn"] == int((~pred & (gen.labels == 0)).sum())
    fpr, tpr, thr = roc_curve(gen.labels, scores)
    assert dump["roc"]["fpr"] == fpr.tolist() and dump["roc"]["thresholds"][0] == np.inf
