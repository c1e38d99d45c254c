"""Verification and retrieval metrics of the feature extractor (counterpart of
the JAX ``engine/metrics.py``), in numpy and torch.

- ``cosine_pair_scores``: ``(cos + 1) / 2`` of index pairs, the production
  ``similarity_f``;
- ``verification_metrics``: ROC AUC, average precision, the optimal threshold
  (the argmin of ``fpr + fnr`` over the ROC curve after its intermediate
  points are dropped), accuracy there with the rule ``score > thr``, accuracy,
  precision and recall at fixed thresholds, TAR@FAR and TRR@FRR;
- ``recall_at_k``: leave-one-out Recall@K, one similarity product and a
  stable descending sort (ties go to the lower index, as ``lax.top_k``).

The JAX package takes ``roc_curve``, ``roc_auc_score`` and
``average_precision_score`` from scikit-learn, which the card does not have;
:func:`roc_curve` and :func:`roc_auc_score` are scikit-learn 1.9's arithmetic
in numpy (binary labels, no sample weights) and the average precision is
``detection_metrics.average_precision``, all three bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from .detection_metrics import average_precision


def cosine_pair_scores(emb, pairs) -> torch.Tensor:
    """``(cos + 1) / 2`` between the rows ``pairs (P, 2)`` of ``emb (N, D)``."""
    emb = torch.as_tensor(emb)
    pairs = torch.as_tensor(np.asarray(pairs), dtype=torch.long, device=emb.device)
    e = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return ((e[pairs[:, 0]] * e[pairs[:, 1]]).sum(-1) + 1.0) / 2.0


def _curve_points(labels: np.ndarray, scores: np.ndarray):
    """``(fps, tps, thresholds)`` at each distinct score, highest first
    (scikit-learn's ``confusion_matrix_at_thresholds``)."""
    order = np.argsort(-scores, kind="stable")
    s, y = scores[order], (labels[order] == 1).astype(np.float64)
    last = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[last]
    fps = 1 + last.astype(np.float64) - tps
    return fps, tps, s[last]


def roc_curve(labels, scores):
    """``sklearn.metrics.roc_curve`` for binary labels with its defaults:
    ``(fpr, tpr, thresholds)``, the first threshold ``inf``, the points on
    straight segments dropped (``drop_intermediate=True``)."""
    labels, scores = np.asarray(labels), np.asarray(scores)
    if not np.isfinite(scores).all():
        raise ValueError("scores must be finite")
    fps, tps, thr = _curve_points(labels, scores)
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def roc_auc_score(labels, scores) -> float:
    """``sklearn.metrics.roc_auc_score`` for binary labels: the trapezoid area
    under :func:`roc_curve`; NaN when only one class is present."""
    labels = np.asarray(labels)
    if len(np.unique(labels)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(np.trapezoid(tpr, fpr))


def verification_metrics(scores, labels, thrs=(), far_thrs=(), frr_thrs=()
                         ) -> dict[str, float]:
    """The pairwise verification suite on the host (float64, as JAX's)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    out: dict[str, float] = {}
    out["ROC AUC"] = roc_auc_score(labels, scores)
    out["AveragePrecision"] = max(0.0, average_precision(labels, scores))

    fpr, tpr, thresholds = roc_curve(labels, scores)
    opt_thr = float(thresholds[int(np.argmin(fpr + (1.0 - tpr)))])
    out["Opt thr"] = opt_thr
    gen = scores[labels == 1]
    imp = scores[labels == 0]
    n_true = int((gen > opt_thr).sum()) + int((imp <= opt_thr).sum())
    out["Accuracy"] = n_true / (len(gen) + len(imp))

    for thr in thrs:
        tp, fp, fn, tn = confusion_counts(scores, labels, thr)
        out[f"Accuracy thr={thr}"] = (tp + tn) / len(scores)
        out[f"Precision thr={thr}"] = tp / max(tp + fp, 1)
        out[f"Recall thr={thr}"] = tp / max(tp + fn, 1)

    neg_sorted = np.sort(imp)
    pos_sorted = np.sort(gen)
    for far in far_thrs:
        k = int(len(neg_sorted) * far)
        if k == 0:
            continue
        thr = neg_sorted[-k]
        if thr in (0.0, 1.0):
            continue
        out[f"TAR@FAR={far}"] = int((gen >= thr).sum()) / max(len(gen), 1)
        out[f"TH@FAR={far}"] = float(thr)
    for frr in frr_thrs:
        thr = pos_sorted[int(len(pos_sorted) * frr)]
        if thr in (0.0, 1.0):
            continue
        out[f"TRR@FRR={frr}"] = int((imp < thr).sum()) / max(len(imp), 1)
        out[f"TH@FRR={frr}"] = float(thr)
    return out


def confusion_counts(scores, labels, thr: float) -> tuple[int, int, int, int]:
    """``(tp, fp, fn, tn)`` of the rule ``score > thr``."""
    scores, labels = np.asarray(scores), np.asarray(labels)
    pred = scores > thr
    return (int((pred & (labels == 1)).sum()), int((pred & (labels == 0)).sum()),
            int((~pred & (labels == 1)).sum()), int((~pred & (labels == 0)).sum()))


def recall_at_k(emb, classes, ks) -> dict[str, float]:
    """Leave-one-out Recall@K: the share of samples with a same-class sample
    among their ``k`` most similar others, over the samples whose class occurs
    among the others. ``emb (N, D)`` and ``classes (N,)``, numpy or torch; the
    product runs where ``emb`` lies."""
    ks = tuple(ks)
    if not ks:
        return {}
    e = torch.as_tensor(emb, dtype=torch.float32)
    c = torch.as_tensor(np.asarray(classes), device=e.device)
    n = e.shape[0]
    max_k = min(max(ks), n - 1)
    e = e / e.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    sim = e @ e.T
    sim = sim - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)   # not oneself
    idx = torch.sort(sim, dim=1, descending=True, stable=True).indices[:, :max_k]
    same = (c[idx] == c[:, None]).cpu().numpy()
    has_other = ((c[None, :] == c[:, None]).sum(1) - 1 > 0).cpu().numpy()
    denom = int(has_other.sum())
    out = {}
    for k in ks:
        hits = int((same[:, :min(k, max_k)].any(axis=1) & has_other).sum())
        out[f"Recall@K={k}"] = hits / max(denom, 1)
    return out
