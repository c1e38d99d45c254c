"""The port's offline scorers (``score_detection``, ``score_landmark``)
against the root scripts: the same printed lines, byte for byte, on the
cases of ``tests/test_scorers.py`` and on seeded random tables (several
annotations and detections an image, missing predictions, an empty species
group), read from tsv files as ``pandas.DataFrame.to_csv(sep="\\t",
index=False)`` writes them (the layout ``prepare_tables`` writes); and
``parse_labeled_studio`` writing the same annotation pickle from a
Label-Studio layout. The port's scorers import neither pandas, scikit-learn
nor PIL."""

import contextlib
import io
import json
import pickle
import re
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import score_detection
import score_landmark
from pets_face_recognition_tpu_torch import native
from pets_face_recognition_tpu_torch import score_detection as p_det
from pets_face_recognition_tpu_torch import score_landmark as p_lmk
from pets_face_recognition_tpu_torch.native.png import write_png

PORT = Path(p_det.__file__).resolve().parent
H = W = 320


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _write(tmp_path, name, columns: dict) -> Path:
    path = tmp_path / name
    pd.DataFrame(columns).to_csv(path, sep="\t", index=False)
    return path


def _box_entry(box, mode="Head", res=(H, W)):
    h, w = res
    return {mode: {"x": box[0] / w * 100, "y": box[1] / h * 100,
                   "width": (box[2] - box[0]) / w * 100, "height": (box[3] - box[1]) / h * 100},
            "resolution": res}


def _same_detection_lines(tmp_path, anno_db, table, mode="Head"):
    anno = tmp_path / "anno.pickle"
    anno.write_bytes(pickle.dumps(anno_db))
    tsv = _write(tmp_path, "det.tsv", table)
    want = _printed(score_detection.main, str(tsv), "data_25", mode, str(anno))
    got = _printed(p_det.main, str(tsv), "data_25", mode, str(anno))
    assert got == want
    return got


def _same_landmark_lines(tmp_path, anno_db, table):
    anno = tmp_path / "anno.pickle"
    anno.write_bytes(pickle.dumps(anno_db))
    tsv = _write(tmp_path, "lmk.tsv", table)
    want = _printed(score_landmark.main, str(tsv), "data_25", str(anno))
    got = _printed(p_lmk.main, str(tsv), "data_25", str(anno))
    assert got == want
    return got


def test_detection_perfect_and_missed(tmp_path):
    """``tests/test_scorers.py``'s case: two perfect dog boxes, a cat without
    a prediction."""
    gt = {"a.jpg": [10, 20, 110, 140], "b.jpg": [30, 40, 150, 170]}
    db = [{k: [_box_entry(v)] for k, v in gt.items()}, {"c.jpg": [_box_entry([5, 5, 50, 50])]}]
    out = _same_detection_lines(tmp_path, db, {
        "query": ["a.jpg", "b.jpg"], "detections": [str([gt["a.jpg"]]), str([gt["b.jpg"]])],
        "scores": [str([0.95]), str([0.9])]})
    assert "Dog Head AP at 0.5 = 1.0" in out and "Cat Head AP at 0.5 = 0.0" in out


def test_landmark_nme_and_empty_group(tmp_path):
    pts = np.array([[100.0, 100.0], [200.0, 100.0], [150.0, 160.0]])
    entry = {"resolution": (H, W)}
    for name, p in zip(("Left eye", "Right eye", "Nose"), pts):
        entry[name] = {"x": p[0] / W * 100, "y": p[1] / H * 100}
    preds = pts.copy()
    preds[:2, 0] += 10
    out = _same_landmark_lines(tmp_path, [{"a.jpg": [entry]}, {}], {
        "query": ["a.jpg"], "Left eye": [str(preds[0].astype(int).tolist())],
        "Right eye": [str(preds[1].astype(int).tolist())],
        "Nose": [str(preds[2].astype(int).tolist())]})
    assert "Dog NME = 0.1" in out and "Cat Length = 0" in out


def _random_box(rng, h, w):
    x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
    return [x0, y0, x0 + rng.randint(10, w // 2), y0 + rng.randint(10, h // 2)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["Head", "Animal"])
def test_detection_lines_on_random_tables(tmp_path, seed, mode):
    rng = np.random.RandomState(seed)
    db, rows = [{}, {}], {"query": [], "detections": [], "scores": []}
    for species in (0, 1):
        if seed == 3 and species == 1:
            continue                        # an empty cat group
        for i in range(rng.randint(3, 9)):
            res = (int(rng.randint(200, 500)), int(rng.randint(200, 500)))
            name = f"{species}_{i}.jpg"
            gts = [_random_box(rng, *res) for _ in range(rng.randint(1, 4))]
            db[species][name] = [_box_entry(b, mode, res) for b in gts]
            if rng.rand() < 0.2:
                continue                    # no prediction for this image
            dets = [list(np.asarray(b) + rng.randint(-8, 9, 4)) for b in gts[:rng.randint(1, 4)]]
            dets += [_random_box(rng, *res) for _ in range(rng.randint(0, 2))]
            rows["query"].append(name)
            rows["detections"].append(str([[int(v) for v in d] for d in dets]))
            rows["scores"].append(str([round(float(s), 4) for s in rng.rand(len(dets))]))
    _same_detection_lines(tmp_path, db, rows, mode)


@pytest.mark.parametrize("seed", range(4))
def test_landmark_lines_on_random_tables(tmp_path, seed):
    rng = np.random.RandomState(100 + seed)
    db, rows = [{}, {}], {"query": [], "Left eye": [], "Right eye": [], "Nose": []}
    for species in (0, 1):
        if seed == 3 and species == 0:
            continue
        for i in range(rng.randint(3, 12)):
            name = f"{species}_{i}.jpg"
            res = (int(rng.randint(200, 500)), int(rng.randint(200, 500)))
            entries = []
            for _ in range(rng.randint(1, 3)):
                e = {"resolution": res}
                for k in ("Left eye", "Right eye", "Nose"):
                    e[k] = {"x": float(rng.uniform(10, 90)), "y": float(rng.uniform(10, 90))}
                entries.append(e)
            db[species][name] = entries
            if rng.rand() < 0.25:
                continue
            rows["query"].append(name)
            for k in ("Left eye", "Right eye", "Nose"):
                rows[k].append(str([int(v) for v in rng.randint(0, 400, 2)]))
    _same_landmark_lines(tmp_path, db, rows)


def test_parse_labeled_studio_writes_the_roots_pickle(tmp_path, monkeypatch):
    """A Label-Studio export (``old``/``new`` cases of ``{dog,cat}.json``) and
    its photos under ``images/<set>/<split>/``: JPEGs and a PNG, whose
    resolutions the port reads without PIL."""
    rng = np.random.RandomState(7)
    images = tmp_path / "images"
    names = []
    for i, (h, w) in enumerate([(64, 80), (90, 50), (33, 47)]):
        folder = images / f"set{i % 2}" / f"split{i}"
        folder.mkdir(parents=True)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        name = f"photo{i}.png" if i == 2 else f"photo{i}.jpg"
        (native.write_jpeg if name.endswith(".jpg") else write_png)(folder / name, img)
        names.append(name)
    export = tmp_path / "export"
    for case, animal, picked in (("old", "dog", names[:2]), ("new", "cat", names[2:])):
        (export / case / "1").mkdir(parents=True)
        entries = [{"file_upload": f"ab12cd-{n}", "annotations": [{"result": [
            {"value": {"rectanglelabels": ["Head"], "x": 10.0, "y": 5.0, "width": 30.0,
                       "height": 40.0}},
            {"value": {"keypointlabels": ["Left eye"], "x": 20.0, "y": 25.0}}]}]}
            for n in picked]
        (export / case / "1" / f"{animal}.json").write_text(json.dumps(entries))
    (export / "new" / "2").mkdir(parents=True)
    (export / "new" / "2" / "dog.json").write_text("[]")
    monkeypatch.chdir(tmp_path)
    score_detection.parse_labeled_studio(export, images, out="root.pickle")
    p_det.parse_labeled_studio(export, images, out="port.pickle")
    root = pickle.loads(Path("root.pickle").read_bytes())
    port = pickle.loads(Path("port.pickle").read_bytes())
    assert port == root
    assert port[0]["photo1.jpg"][0]["resolution"] == (90, 50)
    assert p_lmk.parse_labeled_studio is p_det.parse_labeled_studio


def test_port_scorers_import_no_pandas_sklearn_or_pil():
    for mod in ("score_detection.py", "score_landmark.py"):
        text = (PORT / mod).read_text()
        assert not re.search(r"^\s*(import|from)\s+(pandas|sklearn|PIL)\b", text, re.MULTILINE)
