"""Retrieval over a kashtanka test split -> a predictions tsv: head-only
(counterpart of the JAX ``generate_tsv_to_reproduce2.py``) or, with
``--body``, the head+body ensemble (``generate_tsv_to_reproduce1.py``).

    python -m pets_face_recognition_tpu_torch.generate_tsv [--data <test>] \\
        [--body] [--output pred_scores_test2.tsv | pred_scores_test1.tsv] \\
        [--stock-preds preds.tsv] [--cache db.pickle] [--seed 0] [--device cuda]

Walks ``<test>/{found,lost}/{<same name>,<extra>}/<card>/{card.json,*.jpg}``,
reads each photo with ``native.decode_single`` (PIL where no native route is
installed or the file is not a JPEG), embeds it with the head pipeline
(``pipelines.build_head_pipeline``: detect, align with kernel K1, embed with
the dog or cat ResNet-50) and, with ``--body``, also with the body pipeline
(``pipelines.build_body_pipeline``: Mask R-CNN box crop, PIL-free
``resize_with_padding`` to 256 x 256, the dog or cat body embedder), scores
every lost/found query card against its gallery by card centroids (the
ensemble rule takes the body score where the head gives none), keeps the top
100, backfills queries without a prediction from the stock tsv when it
exists, and writes the tsv. The models are those of
``pipelines.build_retrieval_models``: the head detector from the port
checkpoint that ``PFR_KEYPOINT_CKPT`` names (at the test budgets of 1000 and
1000, one detection), the body detector from ``PFR_MASK_CKPT`` and the
embedders from their ``PFR_*_FE_CKPT``, each with weights random from
``--seed`` where no checkpoint is found. ``PFR_KEYPOINT_ARCH`` picks the
detector, ``resnet50`` (default) or ``mobile`` (the MobileNetV3-Large keypoint
R-CNN), as in the JAX ``configs/pipelines.py``. ``PFR_RETRIEVAL_THR`` sets the
detection threshold (default 0.9); ``PFR_SCORES_DUMP=<path.npz>`` also
writes every query's full score row.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from pathlib import Path
from typing import Callable

import numpy as np

from . import native
from .device import resolve_device
from .pipelines import (build_body_pipeline, build_head_pipeline, build_retrieval_models,
                        keypoint_arch)
from .retrieval import (CardRecord, backfill_missing, create_table, write_scores_dump,
                        write_tsv)

OUTPUT = "pred_scores_test2.tsv"
OUTPUT_BODY = "pred_scores_test1.tsv"
# the committed miniature kashtanka test split (32 photos)
DEFAULT_DATA = Path(__file__).resolve().parent / "testdata" / "kashtanka_test"


def read_image(path: Path) -> np.ndarray:
    """An ``(H, W, 3)`` uint8 RGB photo; ``OSError`` if it does not decode."""
    if native.is_available() and path.suffix.lower() in (".jpg", ".jpeg"):
        img = native.decode_single(path)
        if img is None:
            raise OSError(f"cannot decode {path}")
        return img
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def process_base(base: Path, head_pipeline: Callable,
                 body_pipeline: Callable | None = None) -> list[CardRecord]:
    """Each card folder of ``base`` -> a record of its images' head (and with
    ``body_pipeline``, body) vectors, each image through the head pipeline
    first; cards where no image gave a vector are left out."""
    records = []
    for folder in sorted(base.iterdir()):
        if not folder.is_dir():
            continue
        type_ = int(json.loads((folder / "card.json").read_text())["animal"])
        head, body = [], []
        for p in folder.iterdir():
            if p.name == "card.json":
                continue
            img = read_image(p)
            for pipeline, out in ((head_pipeline, head), (body_pipeline, body)):
                v = None if pipeline is None else pipeline(img, type_)
                if v is not None:
                    out.append(np.asarray(v))
        if head or body:
            records.append(CardRecord(
                name=folder.name, type=type_,
                head_vectors=np.stack(head) if head else np.zeros((0, 512)),
                body_vectors=np.stack(body) if body else np.zeros((0, 512))))
    return records


def prepare_data(path: Path, head_pipeline: Callable, cache: Path | None = None,
                 body_pipeline: Callable | None = None) -> dict:
    """``{found, lost}`` -> ``(query records, gallery records)``: the folder
    named as its parent holds the queries, the other one the gallery. With
    ``cache``, a pickle that this function wrote before is read instead."""
    if cache is not None and cache.exists():
        with open(cache, "rb") as f:
            return pickle.load(f)
    if not ((path / "found").exists() and (path / "lost").exists()):
        raise FileNotFoundError(f"{path}: expected found/ and lost/")
    db = {}
    for big_folder in ((path / "found").resolve(), (path / "lost").resolve()):
        initial_base = big_folder / big_folder.name
        extra_base = [p for p in big_folder.iterdir() if p.resolve() != initial_base][0]
        db[big_folder] = (process_base(initial_base, head_pipeline, body_pipeline),
                          process_base(extra_base, head_pipeline, body_pipeline))
    if cache is not None:
        with open(cache, "wb") as f:
            pickle.dump(db, f)
    return db


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", type=Path, default=DEFAULT_DATA,
                        help="kashtanka test split (default: the package's miniature)")
    parser.add_argument("--body", action="store_true",
                        help="head+body ensemble (Mask R-CNN body vectors as well)")
    parser.add_argument("--output", type=Path, default=None,
                        help=f"default {OUTPUT}, with --body {OUTPUT_BODY}")
    parser.add_argument("--stock-preds", type=Path, default=Path("preds.tsv"))
    parser.add_argument("--cache", type=Path, default=None,
                        help="pickle cache of the embedding DB")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    output = args.output or Path(OUTPUT_BODY if args.body else OUTPUT)
    arch = keypoint_arch()
    models = (build_retrieval_models(dev, args.seed, arch, body=True) if args.body
              else build_retrieval_models(dev, args.seed, arch))
    head_pipeline = build_head_pipeline(*models[:3], device=dev)
    body_pipeline = build_body_pipeline(*models[3:], device=dev) if args.body else None
    db = prepare_data(args.data.resolve(), head_pipeline, args.cache, body_pipeline)
    dump_path = os.environ.get("PFR_SCORES_DUMP")
    dump = {} if dump_path else None
    rows = create_table(db, dev, dump)
    if args.stock_preds.exists():
        rows = backfill_missing(rows, args.stock_preds)
    output.parent.mkdir(parents=True, exist_ok=True)
    write_tsv(rows, output)
    if dump is not None:
        print(f"scores dump: {len(dump)} queries -> {write_scores_dump(dump, dump_path)}")
    print(f"wrote {output} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
