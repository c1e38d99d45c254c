"""Config factories (counterpart of the JAX ``config_presets.py``): only the
keypoint R-CNN one is ported; the feature-extractor and Mask R-CNN ones come
with their training (ROADMAP §1)."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np

from .data_loading import CatLMDDataset, CatLMDSubset, DataLoader
from .utils.collate import DetectionCollate
from .utils.optim import detection_sgd_optimizer

DOG_FIXTURES = (("paths.pickle", "others.pickle"), ("paths2.pickle", "others2.pickle"))


def build_keypoint_config(
    data_root: str = "../pets_datasets",
    seed: int = 123,
    n_epochs: int = 25,
    train_batch_size: int = 16,
    test_batch_size: int = 8,
    image_size: tuple[int, int] = (640, 640),
    max_boxes: int = 4,
    output: str = "results",
    num_workers: int = 8,
    fixtures_dir: str = ".",
    arch: str = "resnet50",
) -> dict:
    """Keypoint R-CNN head+landmark config (the JAX ``build_keypoint_config``,
    reference ``configs/keypoint/keypoints_config.py``): CAT_DATASET (or
    ``cats/``) landmark files under ``data_root`` with an 80/20 split of a
    ``RandomState(seed)`` permutation, rot90 augmentation on the training
    part, 3 keypoints, 1 detection an image; SGD lr 5e-3, momentum 0.9,
    weight decay 1e-4, the rate x 0.1 at epochs 18 and 23.

    ``optimizer(config)`` returns the optimiser factory the controller calls
    with the model's parameters (``params -> (SGD, schedule)``). ``arch``:
    ``"resnet50"`` (ResNet-50-FPN, frozen trunk statistics) or ``"mobile"``
    (MobileNetV3-Large with live BatchNorm at momentum 0.9). The JAX config
    also concatenates two dog-annotation fixtures when their pickles are in
    ``fixtures_dir``; that dataset is not ported, and finding them raises."""
    from .engine.detector_controller import keypoint_model

    for names in DOG_FIXTURES:
        if all((Path(fixtures_dir) / n).exists() for n in names):
            raise NotImplementedError(
                f"{names} found in {fixtures_dir}: the dog-annotation SimpleDataset "
                "is not ported (ROADMAP §1)")
    cat_dir = Path(data_root) / "CAT_DATASET"
    if not cat_dir.exists():
        cat_dir = Path(data_root) / "cats"
    base = CatLMDDataset(cat_dir)
    n = len(base)
    perm = np.random.RandomState(seed).permutation(n)
    split = int(n * 0.8)
    train_ds = CatLMDSubset(base, perm[:split].tolist(), rotate90=True, seed=seed)
    val_ds = CatLMDSubset(base, perm[split:].tolist())
    collate = DetectionCollate(image_size, max_boxes=max_boxes, num_keypoints=3)

    def model():
        return keypoint_model(arch)

    def optimizer(config):
        steps = max(split // train_batch_size, 1)
        return partial(detection_sgd_optimizer, lr=5e-3,
                       milestones_steps=[18 * steps, 23 * steps])

    def train_dataloader():
        return DataLoader(train_ds, train_batch_size, shuffle=True, seed=seed,
                          drop_last=True, collate_fn=collate, num_workers=num_workers)

    def val_dataloader():
        return DataLoader(val_ds, test_batch_size, shuffle=False, drop_last=True,
                          collate_fn=collate, num_workers=num_workers)

    out = Path(output)
    out.mkdir(exist_ok=True)
    return dict(
        seed=seed, n_epochs=n_epochs,
        train_batch_size=train_batch_size, test_batch_size=test_batch_size,
        image_size=image_size, max_boxes=max_boxes,
        model=model, optimizer=optimizer,
        train_dataloader=train_dataloader, val_dataloader=val_dataloader,
        output=out, experiment_name="Keypoints",
        run_name="keypoint_rcnn" if arch == "resnet50" else f"keypoint_rcnn_{arch}",
    )
