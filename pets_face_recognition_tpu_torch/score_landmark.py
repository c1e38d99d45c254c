"""Offline landmark (NME) scorer against Label-Studio ground truth
(counterpart of the root ``score_landmark.py``, without pandas).

Reads a landmark tsv (columns ``query``, ``Left eye``, ``Right eye``,
``Nose``; the ``detected_landmarks.tsv`` that ``prepare_tables`` writes) with
the ``csv`` module and prints, per species, the NME normalised by the ground
truth's inter-eye distance: mean, the mean between the 0.05 and 0.95
quantiles, median and quartiles, byte for byte as the root script prints
them. As the reference: only each image's first annotation is used, the NME
averages the eyes only (the nose is dropped), and a species with no matched
prediction prints its ``Length`` alone.

    python -m pets_face_recognition_tpu_torch.score_landmark detected_landmarks.tsv \\
        data_25 [--anno data_25_anno.pickle]
"""

from __future__ import annotations

import argparse
import pickle
from ast import literal_eval
from contextlib import suppress
from pathlib import Path

import numpy as np

from .score_detection import parse_labeled_studio, read_tsv

__all__ = ["parse_labeled_studio", "evaluate", "compute_scores_data_25", "main"]


def evaluate(preds, g_t, names) -> dict[str, float]:
    metrics = {}
    to_average = []
    for i in range(len(g_t)):
        d = ((g_t[i][0] - g_t[i][1]) ** 2).sum() ** 0.5
        nme = ((preds[i][:-1] - g_t[i][:-1]) ** 2).sum(axis=1) ** 0.5 / d
        to_average.extend(nme)
    to_average = np.asarray(to_average)
    metrics["Length"] = len(to_average)
    if not len(to_average):
        return metrics
    metrics["NME"] = float(np.mean(to_average))
    lo, hi = np.quantile(to_average, 0.05), np.quantile(to_average, 0.95)
    metrics["NME 0.05 0.95"] = float(to_average[(to_average > lo) & (to_average < hi)].mean())
    metrics["NME median"] = float(np.median(to_average))
    metrics["NME 0.75"] = float(np.quantile(to_average, 0.75))
    metrics["NME 0.25"] = float(np.quantile(to_average, 0.25))
    return metrics


def compute_scores_data_25(rows: list[dict[str, str]],
                           anno_path: str = "data_25_anno.pickle") -> None:
    with open(anno_path, "rb") as f:
        db = pickle.load(f)
    cut_db = [{}, {}]
    for i in range(len(db)):
        for k, v in db[i].items():
            detections = []
            with suppress(KeyError):
                for j in range(len(v)):
                    pts = []
                    for mode in ("Left eye", "Right eye", "Nose"):
                        t = v[j][mode]
                        pts.append(np.round([t["x"], t["y"]]).astype(int))
                    h, w = v[j]["resolution"]
                    detections.append(np.array(pts) * np.asarray([w, h])[None] / 100)
            if detections:
                cut_db[i][k] = detections[0]

    d = {row["query"]: row for row in rows}
    for tag, i in zip(("Dog", "Cat"), range(len(cut_db))):
        preds, g_t, names = [], [], []
        for k, true_detections in cut_db[i].items():
            with suppress(KeyError):
                preds.append(np.array((literal_eval(d[k]["Left eye"]),
                                       literal_eval(d[k]["Right eye"]),
                                       literal_eval(d[k]["Nose"]))))
                g_t.append(true_detections)
                names.append(k)
        metrics = evaluate(preds, g_t, names)
        print(*[f"{tag} {k} = {v}" for k, v in metrics.items()], sep="\n")
    print()


available_ds = {"data_25": compute_scores_data_25}


def main(path: str, ds: str, anno: str = "data_25_anno.pickle") -> None:
    path = Path(path)
    assert path.exists(), "Incorrect path to the .tsv file"
    assert ds in available_ds, f"Invalid ds. Choose from {tuple(available_ds)}"
    columns, rows = read_tsv(path)
    assert all(c in columns for c in ("query", "Left eye", "Right eye", "Nose")), (
        "Incorrectly formatted .tsv file")
    available_ds[ds](rows, anno)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path")
    parser.add_argument("ds")
    parser.add_argument("--anno", default="data_25_anno.pickle")
    a = parser.parse_args()
    main(a.path, a.ds, a.anno)
