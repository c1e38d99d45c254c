"""Offline detection scorer against Label-Studio ground truth (counterpart of
the root ``score_detection.py``, without pandas, scikit-learn or PIL).

Reads a prediction tsv (columns ``query``, ``detections``, ``scores``; the
``detections.tsv`` tables that ``prepare_tables`` writes) with the ``csv``
module, matches each image's predictions greedily, in stored order, against
the ``data_25_anno.pickle`` annotations at IoU thresholds {0.5, 0.7, 0.75,
0.9}, and prints AP per species and mode and the root script's ``IoU`` line,
byte for byte as the root script prints them. AP is
``engine.detection_metrics.average_precision``, bit-equal to scikit-learn's
``average_precision_score``. :func:`parse_labeled_studio` writes the
annotation pickle, each image's resolution read by ``native.read_rgb``.

    python -m pets_face_recognition_tpu_torch.score_detection detected_head.tsv \\
        data_25 Head [--anno data_25_anno.pickle]
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
from ast import literal_eval
from contextlib import suppress
from pathlib import Path

import numpy as np

from .engine.detection_metrics import average_precision
from .native import read_rgb

THRESHOLDS = (0.5, 0.7, 0.75, 0.9)


def read_tsv(path: str | Path) -> tuple[list[str], list[dict[str, str]]]:
    """A tab-separated table with a header -> ``(columns, rows)``, every cell
    the string it holds."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        return list(reader.fieldnames or []), list(reader)


def parse_labeled_studio(p: Path, p2: Path, out: str = "data_25_anno.pickle") -> None:
    """Label-Studio exports under ``p/{old,new}/<id>/{dog,cat}.json`` and the
    images under ``p2/*/*/`` -> the annotation pickle: for dogs and cats, each
    image's annotations (labels -> the Label-Studio value, and its
    ``resolution`` ``(h, w)``)."""
    processed = [{}, {}]
    img_d_p = {j.name: j for i in p2.resolve().iterdir() for k in i.iterdir()
               for j in k.iterdir()}
    for case in ("old", "new"):
        for ids in (p / case).iterdir():
            for js in ids.iterdir():
                t = json.loads(js.read_text())
                animal_type = ["dog", "cat"].index(js.name[:-5])
                for entry in t:
                    img_name = "-".join(entry["file_upload"].split("-")[1:])
                    tmp = []
                    for ann in entry["annotations"]:
                        tmp.append({})
                        for j in ann["result"]:
                            if "keypointlabels" in j["value"]:
                                tmp[-1][j["value"]["keypointlabels"][0]] = j["value"]
                            else:
                                tmp[-1][j["value"]["rectanglelabels"][0]] = j["value"]
                        tmp[-1]["resolution"] = read_rgb(img_d_p[img_name]).shape[:-1]
                    processed[animal_type][img_name] = tmp
    with open(out, "wb") as f:
        pickle.dump(processed, f)


def intersection_over_union(dt_bbox, gt_bbox):
    x0 = max(dt_bbox[0], gt_bbox[0])
    x1 = min(dt_bbox[2], gt_bbox[2])
    y0 = max(dt_bbox[1], gt_bbox[1])
    y1 = min(dt_bbox[3], gt_bbox[3])
    inter = (x1 - x0) * (y1 - y0)
    union = ((dt_bbox[2] - dt_bbox[0]) * (dt_bbox[3] - dt_bbox[1])
             + (gt_bbox[2] - gt_bbox[0]) * (gt_bbox[3] - gt_bbox[1]) - inter)
    return inter / union


def evaluate(preds, scores, g_t) -> dict[str, float]:
    """Greedy AP at :data:`THRESHOLDS` and the reference's ``IoU``.

    The reference binds ``ious`` to each prediction's IoUs against its
    image's remaining ground truth inside the loop, so the threshold-0.5
    appends land on lists that are dropped: the printed ``IoU`` is the mean
    of the last prediction's IoUs in the last (0.9) pass, ``nan`` without
    predictions. Kept as the root script keeps it.
    """
    metrics = {}
    ious = []
    for thr in THRESHOLDS:
        results = []
        remaining = [list(map(list, g)) for g in g_t]
        for j in range(len(preds)):
            for a in range(len(preds[j])):
                dt = preds[j][a]
                results.append({"score": scores[j][a]})
                ious = [intersection_over_union(remaining[j][b], dt)
                        for b in range(len(remaining[j]))]
                if ious:
                    max_gt_id = int(np.argmax(ious))
                    max_iou = ious[max_gt_id]
                else:
                    max_gt_id, max_iou = -1, -1
                if max_gt_id >= 0 and max_iou >= thr:
                    results[-1]["TP"] = 1
                    del remaining[j][max_gt_id]
                    if thr == 0.5:
                        ious.append(max_iou)
                else:
                    results[-1]["TP"] = 0
                    if thr == 0.5:
                        ious.append(0)
        results = sorted(results, key=lambda k: k["score"], reverse=True)
        flags = [r["TP"] for r in results]
        svals = [r["score"] for r in results]
        if not flags:
            ap = 0.0
        elif all(f == flags[0] for f in flags):
            ap = float(flags[0])
        else:
            ap = average_precision(flags, svals)
        metrics[f"AP at {thr}"] = ap
    metrics["IoU"] = float(np.mean(ious)) if ious else float("nan")
    return metrics


def compute_scores_data_25(rows: list[dict[str, str]], mode: str,
                           anno_path: str = "data_25_anno.pickle") -> None:
    with open(anno_path, "rb") as f:
        db = pickle.load(f)
    cut_db = [{}, {}]
    for i in range(len(db)):
        for k, v in db[i].items():
            detections = []
            with suppress(KeyError):
                for j in range(len(v)):
                    t = v[j][mode]
                    h, w = v[j]["resolution"]
                    box = [t["x"], t["y"], t["x"] + t["width"], t["y"] + t["height"]]
                    box = [box[0] * w / 100, box[1] * h / 100,
                           box[2] * w / 100, box[3] * h / 100]
                    detections.append(np.round(box).astype(int).tolist())
            if detections:
                cut_db[i][k] = detections

    d = {row["query"]: row for row in rows}
    for tag, i in zip(("Dog", "Cat"), range(len(cut_db))):
        preds, g_t, scores = [], [], []
        for k, true_detections in cut_db[i].items():
            g_t.append(true_detections)
            if k in d:
                preds.append(literal_eval(d[k]["detections"]))
                scores.append(literal_eval(d[k]["scores"]))
            else:
                preds.append([])
                scores.append([])
        metrics = evaluate(preds, scores, g_t)
        print(*[f"{tag} {mode} {k} = {v}" for k, v in metrics.items()], sep="\n")
    print()


available_ds = {"data_25": compute_scores_data_25}


def main(path: str, ds: str, mode: str, anno: str = "data_25_anno.pickle") -> None:
    path = Path(path)
    assert path.exists(), "Incorrect path to the .tsv file"
    assert ds in available_ds, f"Invalid ds. Choose from {tuple(available_ds)}"
    assert mode in ("Head", "Animal"), "Invalid mode: choose Head or Animal"
    columns, rows = read_tsv(path)
    assert all(c in columns for c in ("query", "detections", "scores")), (
        "Incorrectly formatted .tsv file")
    available_ds[ds](rows, mode, anno)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path")
    parser.add_argument("ds")
    parser.add_argument("mode")
    parser.add_argument("--anno", default="data_25_anno.pickle")
    a = parser.parse_args()
    main(a.path, a.ds, a.mode, a.anno)
