"""Detection and keypoint metrics on the host (counterpart of the JAX
``engine/detection_metrics.py``), in numpy with the JAX semantics:

- **AP@thr**: predictions are visited in per-image output order; each is
  matched greedily to the remaining same-label ground truth of highest IoU
  (a match consumes it); the TP flags are scored by :func:`average_precision`.
- **Mean/Median IoU**: IoU of the rounded top detection against the first
  ground truth of each image.
- **Mask IoU**: predicted masks cut at 0.5, targets truncated to int;
  ``TP pixels / union pixels`` per image, NaNs dropped.
- **MAE/MSE/NMAE/NME**: keypoint errors, NME normalised per instance by the
  ground truth's inter-eye distance (keypoints 0 and 1).

The JAX file scores AP with ``sklearn.metrics.average_precision_score``; the
port has no scikit-learn and computes the same number itself. Inputs are
per-image dicts of numpy arrays, split from the model's padded outputs by
:func:`unpad_detections` and :func:`unpad_targets`.
"""

from __future__ import annotations

import numpy as np


def unpad_detections(dets: dict, batch_size: int) -> list[dict]:
    """Split padded ``(B, D, ...)`` detections into per-image dicts of their
    valid rows."""
    out = []
    for b in range(batch_size):
        valid = np.asarray(dets["valid"][b]).astype(bool)
        entry = {
            "boxes": np.asarray(dets["boxes"][b])[valid],
            "labels": np.asarray(dets["labels"][b])[valid],
            "scores": np.asarray(dets["scores"][b])[valid],
        }
        if "masks" in dets:
            entry["masks"] = np.asarray(dets["masks"][b])[valid]
        if "keypoints" in dets:
            entry["keypoints"] = np.asarray(dets["keypoints"][b])[valid]
        out.append(entry)
    return out


def unpad_targets(targets: dict, batch_size: int) -> list[dict]:
    out = []
    for b in range(batch_size):
        valid = np.asarray(targets["valid"][b]).astype(bool)
        entry = {
            "boxes": np.asarray(targets["boxes"][b])[valid],
            "labels": np.asarray(targets["labels"][b])[valid],
        }
        if "masks" in targets:
            entry["masks"] = np.asarray(targets["masks"][b])[valid]
        if "keypoints" in targets:
            entry["keypoints"] = np.asarray(targets["keypoints"][b])[valid]
        out.append(entry)
    return out


def intersection_over_union(dt: np.ndarray, gt: np.ndarray) -> float:
    """Signed IoU as the reference computes it: no ``max(0, .)`` clamp, so
    disjoint boxes give a meaningless but reproduced value."""
    x0 = max(dt[0], gt[0]); x1 = min(dt[2], gt[2])
    y0 = max(dt[1], gt[1]); y1 = min(dt[3], gt[3])
    inter = (x1 - x0) * (y1 - y0)
    union = (
        (dt[2] - dt[0]) * (dt[3] - dt[1])
        + (gt[2] - gt[0]) * (gt[3] - gt[1])
        - inter
    )
    return float(inter / union) if union != 0 else 0.0


def average_precision(flags, scores) -> float:
    """Binary average precision as ``sklearn.metrics.average_precision_score``
    computes it: predictions sorted by score, descending and stable; one
    precision/recall point where the score changes (tied scores are one
    threshold) and one at the end; ``AP = -sum(diff(recall) * precision)``
    over the points from the highest threshold down, no interpolation."""
    y = np.asarray(flags) == 1
    s = np.asarray(scores)
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    last = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[last]
    fps = 1 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    # sklearn's curve runs from the lowest threshold up and ends at (1, 0)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def greedy_ap(preds: list[dict], targets: list[dict], thr: float) -> float:
    """Greedy-matching AP at one IoU threshold (reference algorithm)."""
    scores, flags = [], []
    for pred, tgt in zip(preds, targets):
        remaining = list(np.asarray(tgt["boxes"], float))
        remaining_labels = list(np.asarray(tgt["labels"]))
        for a in range(len(pred["boxes"])):
            dt = pred["boxes"][a]
            scores.append(float(pred["scores"][a]))
            cand = [
                (b, intersection_over_union(remaining[b], dt))
                for b in range(len(remaining))
                if pred["labels"][a] == remaining_labels[b]
            ]
            if cand:
                best_b, best_iou = max(cand, key=lambda t: t[1])
            else:
                best_b, best_iou = -1, -1.0
            if best_b >= 0 and best_iou >= thr:
                flags.append(1)
                del remaining[best_b]
                del remaining_labels[best_b]
            else:
                flags.append(0)
    if not flags:
        return 0.0
    if all(f == flags[0] for f in flags):
        # AP is undefined for one class; the reference scores it directly
        return float(flags[0])
    return average_precision(flags, scores)


def top_detection_iou(preds: list[dict], targets: list[dict]) -> dict[str, float]:
    """Mean/median IoU of the (rounded) top detection against the first GT."""
    ious = [
        intersection_over_union(np.round(p["boxes"][0]), t["boxes"][0])
        for p, t in zip(preds, targets)
        if len(p["boxes"]) and len(t["boxes"])
    ]
    if not ious:
        return {"Mean IoU": float("nan"), "Median IoU": float("nan")}
    return {"Mean IoU": float(np.mean(ious)),
            "Median IoU": float(np.median(ious))}


def mask_iou(preds: list[dict], targets: list[dict]) -> float:
    """Pixel IoU of the predicted masks (>= 0.5) against the targets
    (truncated to int) over each image's first ``min(#pred, #true)`` masks;
    the mean over images, NaNs (an empty union) dropped."""
    vals = []
    for p, t in zip(preds, targets):
        if "masks" not in p or "masks" not in t or not len(t["masks"]):
            continue
        pm = (np.asarray(p["masks"]) >= 0.5).astype(int)
        tm = np.asarray(t["masks"]).astype(int)
        n = min(len(pm), len(tm))
        if n == 0:
            continue
        pm, tm = pm[:n], tm[:n]
        union = ((pm == 1) | (tm == 1)).sum()
        inter = ((pm == tm) & (tm == 1)).sum()
        vals.append(inter / union if union else np.nan)
    vals = [v for v in vals if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")


def keypoint_errors(preds: list[dict], targets: list[dict]) -> dict[str, float]:
    """MAE/MSE/NMAE/NME: per-landmark errors, normalised by the ground
    truth's inter-eye distance (landmarks 0 and 1)."""
    mae, mse, norm_abs, norm_sq = [], [], [], []
    for p, t in zip(preds, targets):
        if "keypoints" not in p or not len(p.get("keypoints", ())):
            continue
        tk = np.asarray(t["keypoints"], float)
        pk = np.asarray(p["keypoints"], float)[: len(tk)]
        if not len(tk):
            continue
        n = len(pk)
        mae.extend(np.abs(pk[:, :, :-1] - tk[:n, :, :-1]).sum(axis=2))
        mse.extend(((pk[:, :, :-1] - tk[:n, :, :-1]) ** 2).sum(axis=2))
        norm_abs.extend(np.abs(tk[:n, 0, :-1] - tk[:n, 1, :-1]).sum(axis=-1))
        norm_sq.extend(((tk[:n, 0, :-1] - tk[:n, 1, :-1]) ** 2).sum(axis=-1))
    if not mae:
        return {}
    mae = np.asarray(mae)
    mse = np.asarray(mse)
    return {
        "MAE": float(np.mean(mae)),
        "MSE": float(np.mean(mse)),
        "NMAE": float(np.mean(mae / np.asarray(norm_abs)[:, None])),
        "NME": float(np.mean(np.sqrt(mse) / np.sqrt(np.asarray(norm_sq))[:, None])),
    }


def detection_metrics(
    preds: list[dict],
    targets: list[dict],
    thresholds: tuple[float, ...] = (0.5, 0.7, 0.9),
    with_masks: bool = False,
    with_keypoints: bool = False,
) -> dict[str, float]:
    """The per-split metric dict the reference logs."""
    out = dict(top_detection_iou(preds, targets))
    for thr in thresholds:
        out[f"AP {int(thr * 100)}"] = greedy_ap(preds, targets, thr)
    if with_masks:
        out["Masks Mean IoU"] = mask_iou(preds, targets)
    if with_keypoints:
        out.update(keypoint_errors(preds, targets))
    return out
