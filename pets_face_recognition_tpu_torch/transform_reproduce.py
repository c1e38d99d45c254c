"""Write the aligned head corpora and the masked body corpora (counterpart of
the JAX ``transform_reproduce.py``). The head route (``aligned``): every photo
of ``data_25`` (dogs and cats) and of the petfinder extras goes through
``Preproc3`` (letterbox, the keypoint R-CNN with kernels K2 and K3, the
landmarks' homography, the K1 warp to 224 x 224) into
``data_25_transformed_v6_{dogs,cats}`` and
``petfinder_extra_{dogs,cats}_transformed_v6``, the feature extractor's
training data. The body route (``masked``): the same photos through
``Preproc4(use_mask=True, mask_thr=0.7)`` (Mask R-CNN with K2 in the RPN and
the box NMS and K3 at 7 x 7 and 14 x 14, the top detection's mask pasted at
the photo's resolution, the photo multiplied by it, the box tightened to it)
into ``data_25_transformed_v4_masked_{dogs,cats}`` and
``petfinder_extra_{dogs,cats}_transformed_v4_masked``.

As the JAX script: the same folder walks and hand-made exclusion lists, a
photo that does not decode or has no head skipped silently, an output that
exists already (or its ``.jpg`` twin) skipped, photos in chunks of the
pipeline's ``serve_batch``, and a crop above 300 x 400 pixels written as
``.jpg``. Crops are written as PIL's default save writes them: a ``.jpg`` at
JPEG quality 75 with 4:2:0 chroma through the port's encoder (libjpeg, or
nvJPEG on a host without it), a ``.png`` through :mod:`.native.png`.

    python -m pets_face_recognition_tpu_torch.transform_reproduce \\
        --data-root ../pets_datasets [--stages aligned,masked] [--device cpu]

The detectors are :func:`pipelines.keypoint_detector`'s (``PFR_KEYPOINT_CKPT``)
and :func:`pipelines.mask_detector`'s (``PFR_MASK_CKPT``), else seeded random
weights, at the pipelines' detection threshold 0.9, as the reference's.
"""

from __future__ import annotations

import argparse
import os
from contextlib import suppress
from pathlib import Path

import numpy as np

from .data_loading import RecDataset
from .device import resolve_device
from .native import png, read_rgb, write_jpeg
from .pipelines import keypoint_detector, mask_detector
from .preprocessor import DEFAULT_BASE_PTS, Preproc3, Preproc4

V = "v6"
V_MASKED = "v4_masked"
MASK_THR = 0.7
BASE_PTS = DEFAULT_BASE_PTS

# bad images the reference excludes by hand (transform_reproduce.py:58-105)
DATA_25_EXCLUDE = [
    "data_25/rl131336/216319.jpg", "data_25/rl378360/660074.jpg",
    "data_25/rf337006/589105.jpg", "data_25/rl341945/597666.jpg",
    "data_25/rl254355/447992.jpg", "data_25/rl302213/529924.jpg",
    "data_25/rf327026/572016.jpg", "data_25/rf287909/505121.jpg",
    "data_25/rf413612/717733.jpg", "data_25/rl257226/452879.jpg",
    "data_25/rl257226/452880.jpg", "data_25/rl411182/713855.jpg",
    "data_25/rf292282/512681.jpg", "data_25/rf263807/464166.jpg",
    "data_25/rf146140/246925.jpg", "data_25/rf230595/407467.jpg",
    "data_25/rl209386/373061.jpg", "data_25/rf428033/742644.jpg",
    "data_25/rl270079/474803.jpg", "data_25/rf278099/488547.jpg",
    "data_25/rl401247/697651.jpg", "data_25/rl381795/666073.jpg",
    "data_25/rf233445/412363.jpg", "data_25/rl223935/650763.jpg",
    "data_25/rl343571/600399.jpg", "data_25/rl381795/666046.jpg",
    "data_25/rl381795/666053.jpg", "data_25/rl381795/666059.jpg",
    "data_25/rl381795/666067.jpg", "data_25/rl381795/666077.jpg",
    "data_25/rl381795/666081.jpg", "data_25/rl381795/666089.jpg",
    "data_25/rl381795/666094.jpg", "data_25/rl381795/666097.jpg",
    "data_25/rl381795/666103.jpg", "data_25/rf133909/221703.jpg",
    "data_25/rf133909/221704.jpg", "data_25/rf133909/221705.jpg",
    "data_25/rf133831/221554.jpg", "data_25/rf133831/221555.jpg",
    "data_25/rf133831/221556.jpg",
]

DATA_ROOT = Path(os.environ.get("PFR_DATA_ROOT", "../pets_datasets"))


def transform_dataset(input_root, preprocessor, output_root=None, paths=None,
                      out_paths=None, batch_size: int = 32) -> list[Path]:
    """Detect, align and save each photo of ``paths`` (default: the
    ``*/*.jpg`` and ``*/*.png`` of ``input_root``) under ``output_root`` at
    its path relative to ``input_root``, or at ``out_paths[i]``. Returns the
    files written."""
    input_root = Path(input_root)
    if paths is None:
        paths = list(input_root.glob("*/*.jpg")) + list(input_root.glob("*/*.png"))
    paths = list(paths)
    if output_root is not None:
        output_root = Path(output_root)
        output_root.mkdir(parents=True, exist_ok=True)

    todo = []
    for i, p in enumerate(paths):
        rel = (output_root / os.path.relpath(p, input_root) if out_paths is None
               else Path(out_paths[i]))
        if rel.exists() or (rel.parent / (rel.name[:-4] + ".jpg")).exists():
            continue
        todo.append((Path(p), rel))

    # a fixed-shape pipeline pads every chunk to serve_batch, so chunk by it
    batch_size = getattr(preprocessor, "serve_batch", None) or batch_size
    written = []
    for start in range(0, len(todo), batch_size):
        images, metas = [], []
        for p, rel in todo[start:start + batch_size]:
            with suppress(OSError, ValueError):
                images.append(read_rgb(p))
                metas.append(rel)
        if not images:
            continue
        outs, valid, _ = preprocessor.batch(images)
        for i in np.nonzero(valid)[0]:
            written.append(_save(outs[i].cpu().numpy(), metas[i]))
    return written


def _save(processed: np.ndarray, rel_path: Path) -> Path:
    """Clip to [0, 255], truncate to uint8 and write as PIL's ``save`` does
    by the name: above 300 x 400 pixels always as ``.jpg``. NaN (the crop of
    a singular map) is written as 0, which is what the JAX script's
    ``cv2.warpPerspective`` leaves for such a map."""
    processed = np.clip(np.nan_to_num(processed, nan=0.0), 0, 255).astype(np.uint8)
    rel_path.parent.mkdir(parents=True, exist_ok=True)
    if processed.shape[0] * processed.shape[1] > 300 * 400:
        rel_path = rel_path.parent / (rel_path.name[:-4] + ".jpg")
    suffix = rel_path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        write_jpeg(rel_path, processed)
    elif suffix == ".png":
        png.write_png(rel_path, processed)
    else:
        raise ValueError(f"no encoder for {rel_path}")
    return rel_path


def data_25(preprocessor, type_: int = 1, data_root: Path | None = None,
            version: str = V) -> list[Path]:
    """``data_25`` cards of ``type_`` (1 dogs, 2 cats), less the exclusion
    list and the images that do not decode, into
    ``data_25_transformed_{version}_{dogs,cats}``."""
    assert type_ in (1, 2)
    root = Path(data_root or DATA_ROOT)
    exclude = [(root / p).resolve() for p in DATA_25_EXCLUDE]
    ds = RecDataset(root / "data_25", type_, 1, paths_to_exclude=exclude)
    paths = [ds.index_to_path[i] for i in range(len(ds))]
    return transform_dataset(root / "data_25", preprocessor,
                             root / f"data_25_transformed_{version}_"
                             f"{'dog' if type_ == 1 else 'cat'}s",
                             paths)


def extra_petfinder(preprocessor, tag: str = "dog", data_root: Path | None = None,
                    version: str = V) -> list[Path]:
    """``petfinder_extra_{dogs,cats}`` less their exclusions into
    ``petfinder_extra_{dogs,cats}_transformed_{version}``."""
    root = Path(data_root or DATA_ROOT)
    if tag == "dog":
        out = root / f"petfinder_extra_dogs_transformed_{version}"
        src = root / "petfinder_extra_dogs"
        exclude = (list((src / "48683845").iterdir()) + list((src / "45528036").iterdir())
                   + [src / "48009947" / "3.png"])
    else:
        out = root / f"petfinder_extra_cats_transformed_{version}"
        src = root / "petfinder_extra_cats"
        exclude = [src / "24355557" / "4.png"]
    exclude = {p.resolve() for p in exclude}
    paths = [j.resolve() for d in src.resolve().iterdir() for j in d.iterdir()
             if j.resolve() not in exclude]
    return transform_dataset(src, preprocessor, output_root=out, paths=paths)


def aligned(preprocessor, data_root: Path | None = None, version: str = V) -> list[Path]:
    """The head route: dog extras, data_25 dogs and cats, cat extras."""
    return (extra_petfinder(preprocessor, "dog", data_root, version)
            + data_25(preprocessor, 1, data_root, version)
            + data_25(preprocessor, 2, data_root, version)
            + extra_petfinder(preprocessor, "cat", data_root, version))


def masked(preprocessor, data_root: Path | None = None) -> list[Path]:
    """The body route: the head route's walks into the ``v4_masked`` corpora,
    ``preprocessor`` a ``Preproc4(use_mask=True, mask_thr=0.7)``."""
    return aligned(preprocessor, data_root, V_MASKED)


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--data-root", type=Path, default=DATA_ROOT,
                        help="datasets root (default ../pets_datasets, env PFR_DATA_ROOT)")
    parser.add_argument("--stages", default="aligned,masked",
                        help="comma list of {aligned,masked} passes to run")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    stages = set(args.stages.split(","))
    if not stages <= {"aligned", "masked"}:
        raise ValueError(f"--stages {args.stages}: a comma list of aligned, masked")
    dev = resolve_device(args.device)
    written = []
    if "aligned" in stages:
        pre3 = Preproc3(keypoint_detector(dev), base_pts=BASE_PTS,
                        dsize=(224, 224, 3), serve_batch=args.batch_size, device=dev)
        written += aligned(pre3, args.data_root)
    if "masked" in stages:
        pre4 = Preproc4(mask_detector(dev), use_mask=True, mask_thr=MASK_THR,
                        serve_batch=args.batch_size, device=dev)
        written += masked(pre4, args.data_root)
    print(f"wrote {len(written)} crops")
    return written


if __name__ == "__main__":
    main()
