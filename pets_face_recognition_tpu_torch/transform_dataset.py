"""Run a pipeline over a folder of card folders (counterpart of the JAX
``transform_dataset.py``): every ``*/*.jpg`` and ``*/*.png`` under
``--input`` through the pipeline at detection threshold ``--thr``, its crop
written under ``--output`` at the same relative path
(``transform_reproduce.transform_dataset``: failures skipped silently,
existing outputs kept). Pipelines: ``head``, ``Preproc3`` (the aligned head,
:func:`pipelines.keypoint_detector`); ``body``, ``Preproc4`` (the Mask R-CNN
body box of :func:`pipelines.mask_detector`, with ``--masked`` the mask
multiplied in at ``--mask-thr`` and the box tightened to it); ``head_bbox``,
``Preproc6`` (the keypoint detector's head box, not aligned).

    python -m pets_face_recognition_tpu_torch.transform_dataset --input DIR \\
        --output DIR [--pipeline head|body|head_bbox] [--thr 0.9] [--masked] \\
        [--mask-thr 0.5] [--batch-size 32] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .device import resolve_device
from .pipelines import keypoint_detector, mask_detector
from .preprocessor import Preproc3, Preproc4, Preproc6
from .transform_reproduce import BASE_PTS, transform_dataset


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--pipeline", choices=("head", "body", "head_bbox"), default="head")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--thr", type=float, default=0.9)
    parser.add_argument("--masked", action="store_true")
    parser.add_argument("--mask-thr", type=float, default=0.5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.pipeline == "head":
        pre = Preproc3(keypoint_detector(dev), thr=args.thr, base_pts=BASE_PTS,
                       dsize=(224, 224, 3), serve_batch=args.batch_size, device=dev)
    elif args.pipeline == "body":
        pre = Preproc4(mask_detector(dev), thr=args.thr, use_mask=args.masked,
                       mask_thr=args.mask_thr, serve_batch=args.batch_size, device=dev)
    else:
        pre = Preproc6(keypoint_detector(dev), thr=args.thr, serve_batch=args.batch_size,
                       device=dev)
    written = transform_dataset(args.input, pre, args.output, batch_size=args.batch_size)
    print(f"wrote {len(written)} crops")
    return written


if __name__ == "__main__":
    main()
