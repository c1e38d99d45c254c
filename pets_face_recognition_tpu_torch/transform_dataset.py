"""Run the head pipeline over a folder of card folders (counterpart of the JAX
``transform_dataset.py --pipeline head``): every ``*/*.jpg`` and ``*/*.png``
under ``--input`` through ``Preproc3`` at detection threshold ``--thr``, its
aligned crop written under ``--output`` at the same relative path
(``transform_reproduce.transform_dataset``: failures skipped silently,
existing outputs kept).

    python -m pets_face_recognition_tpu_torch.transform_dataset --input DIR \\
        --output DIR [--thr 0.9] [--batch-size 32] [--device cpu]

The detector is :func:`pipelines.keypoint_detector`'s. The body and
head-bbox pipelines need Mask R-CNN and ``Preproc6``, not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .device import resolve_device
from .pipelines import keypoint_detector
from .preprocessor import Preproc3
from .transform_reproduce import BASE_PTS, transform_dataset


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--pipeline", choices=("head",), default="head")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--thr", type=float, default=0.9)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    pre = Preproc3(keypoint_detector(dev), thr=args.thr, base_pts=BASE_PTS,
                   dsize=(224, 224, 3), serve_batch=args.batch_size, device=dev)
    written = transform_dataset(args.input, pre, args.output, batch_size=args.batch_size)
    print(f"wrote {len(written)} crops")
    return written


if __name__ == "__main__":
    main()
