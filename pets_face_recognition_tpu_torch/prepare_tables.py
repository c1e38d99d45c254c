"""Run the production pipelines over ``data_25_labeled`` and write the
prediction tables of the offline scorers (counterpart of the JAX
``prepare_tables.py``), without pandas:

- ``landmark.tsv`` (``Preproc3``): ``query``, ``Left eye``, ``Right eye``,
  ``Nose``, each landmark the rounded ``[x, y]``;
- ``detected_body.tsv`` (``Preproc4`` with the mask at 0.7: the box
  tightened to the mask) and ``detected_head.tsv`` (``Preproc6``): ``query``,
  ``detections`` (``[[x1, y1, x2, y2]]``, rounded), ``scores`` (every
  detection slot's score as a plain Python float, 0 where invalid).

Lists are written as ``str(list)``, and the files as pandas'
``DataFrame.to_csv(sep="\\t", index=False)`` writes them, byte for byte.
Photos are read with ``native.read_rgb``; one that does not decode or that a
pipeline rejects is skipped silently.

    python -m pets_face_recognition_tpu_torch.prepare_tables \\
        [--data ../pets_datasets/data_25_labeled] [--thr 0.9] [--out-dir .] \\
        [--device cuda]

The detectors are :func:`pipelines.keypoint_detector`'s (``PFR_KEYPOINT_CKPT``)
and :func:`pipelines.mask_detector`'s (``PFR_MASK_CKPT``), else seeded random
weights.
"""

from __future__ import annotations

import argparse
import csv
from contextlib import suppress
from pathlib import Path
from typing import Iterator

from .device import resolve_device
from .native import read_rgb
from .pipelines import keypoint_detector, mask_detector
from .preprocessor import Preproc3, Preproc4, Preproc6
from .transform_reproduce import BASE_PTS

LANDMARK_COLUMNS = ("query", "Left eye", "Right eye", "Nose")
DETECTION_COLUMNS = ("query", "detections", "scores")
MASK_THR = 0.7


def image_paths(root: Path) -> Iterator[Path]:
    """``<root>/<set>/<card>/*.jpg`` then ``*.png`` of each set, in directory
    order."""
    for input_root in root.iterdir():
        yield from input_root.glob("*/*.jpg")
        yield from input_root.glob("*/*.png")


def write_table(rows: list[tuple], columns: tuple[str, ...], path: str | Path) -> None:
    """``rows`` under ``columns``, tab-separated, each cell as ``str``: the
    bytes of ``DataFrame.to_csv(path, sep="\\t", index=False)``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([tuple(str(c) for c in r) for r in rows])


def prepare_table(preprocessor, data_root: Path, out_path: str | Path | None = None) -> Path:
    """One table: ``landmark.tsv`` for a ``Preproc3``, ``detected_body.tsv``
    for a ``Preproc4``, ``detected_head.tsv`` for a ``Preproc6``, or
    ``out_path``. Returns the path written."""
    preprocessor.return_for_metrics = True
    rows = []
    if isinstance(preprocessor, Preproc3):
        for p in image_paths(data_root):
            with suppress(AssertionError, ValueError, OSError):
                rows.append((p.name, *preprocessor(read_rgb(p)).tolist()))
        columns, default = LANDMARK_COLUMNS, "landmark.tsv"
    else:
        for p in image_paths(data_root):
            with suppress(AssertionError, ValueError, OSError):
                bbox, score = preprocessor(read_rgb(p))
                rows.append((p.name, [bbox.tolist()], [float(s) for s in score]))
        columns = DETECTION_COLUMNS
        default = "detected_head.tsv" if isinstance(preprocessor, Preproc6) \
            else "detected_body.tsv"
    path = Path(out_path or default)
    write_table(rows, columns, path)
    return path


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=Path, default=Path("../pets_datasets/data_25_labeled"))
    parser.add_argument("--thr", type=float, default=0.9,
                        help="detection score threshold (the reference's 0.9)")
    parser.add_argument("--out-dir", type=Path, default=Path("."))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    data = args.data.resolve()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    keypoints, body = keypoint_detector(dev), mask_detector(dev)
    written = [
        prepare_table(Preproc3(keypoints, thr=args.thr, base_pts=BASE_PTS,
                               dsize=(224, 224, 3), device=dev), data,
                      args.out_dir / "landmark.tsv"),
        prepare_table(Preproc4(body, thr=args.thr, use_mask=True, mask_thr=MASK_THR,
                               device=dev), data, args.out_dir / "detected_body.tsv"),
        prepare_table(Preproc6(keypoints, thr=args.thr, device=dev), data,
                      args.out_dir / "detected_head.tsv"),
    ]
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
