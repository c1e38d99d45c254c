"""Config factories (counterpart of the JAX ``config_presets.py``): the
feature extractor's, the Mask R-CNN body detector's and the keypoint
R-CNN's."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np

from .data_loading import (CatLMDDataset, CatLMDSubset, ConcatDataset, DataLoader,
                           PairGenerator, RecDataset, RecSubset, SimpleDataset,
                           simple_init_dataset)
from .utils.collate import DetectionCollate
from .utils.optim import detection_sgd_optimizer, fe_adamw_optimizer, fe_sgd_optimizer
from .utils.preprocs import FETrainAug, FEValAug

DOG_FIXTURES = (("paths.pickle", "others.pickle"), ("paths2.pickle", "others2.pickle"))


def build_fe_config(
    dataset_dir: str,
    extra_dataset_dir: str | None = None,
    seed: int = 123,
    n_epochs: int = 50,
    train_batch_size: int = 64,
    test_batch_size: int = 20,
    optimizer_kind: str = "sgd",
    lr: float | None = None,
    crop: int = 220,
    size: int = 224,
    emb_size: int = 512,
    experiment_name: str = "default",
    run_name: str = "run",
    output: str = "results",
    num_workers: int = 8,
    n_pairs: int = 10000,
) -> dict:
    """The feature extractor's config (the JAX ``build_fe_config``, reference
    ``configs/cat_fe/cat_fe_head.py``): aligned crops in card folders under
    ``dataset_dir`` (a simple scan, at least 3 images an identity), split
    50/50 by identity from ``RandomState(seed).permutation``; the training
    identities relabelled 0..n-1 and, when ``extra_dataset_dir`` exists, its
    identities appended after them (``start_class``) through
    ``ConcatDataset``; ``FETrainAug`` on the training crops, ``FEValAug`` on
    the validation ones; ``PairGenerator(dataset, n_pairs, 1, None, seed,
    val_users)``; ResNet-50 -> ``emb_size`` with ArcFace (s 64, m 0.5) and the
    focal loss (gamma 0); SGD in three groups at ``lr`` (1e-2) or AdamW
    (``optimizer_kind="adamw"``, 1e-4), the rate x 0.1 at epochs 35 and 45;
    ``thrs`` ``linspace(0.5, 0.99, 6)``, the ``far_thr`` list, ``k`` 5, 10,
    100. The port trains in float32: the JAX ``compute_dtype`` (bfloat16 off
    the CPU) of FE training is not ported yet (ROADMAP §1).

    ``optimizer(config)`` returns the factory ``model -> (optimizer,
    schedule)`` the FE controller calls with the wrapper."""
    from .losses import SoftmaxBasedMetricLearning
    from .models.embedder import resnet50_embedder

    train_aug = FETrainAug(np.random.RandomState(seed), crop=crop, size=size)
    val_aug = FEValAug()

    dataset = RecDataset(Path(dataset_dir), None, 3, init_dataset_method=simple_init_dataset)
    perm = np.random.RandomState(seed).permutation(dataset.get_users())
    tr_size = 0.5
    train_users = [perm[i] for i in range(int(len(perm) * tr_size))]
    val_users = [perm[i] for i in range(int(len(perm) * tr_size), len(perm))]
    train_indices = [j for u in train_users for j in dataset.uid_to_indices[u]]
    val_indices = [j for u in val_users for j in dataset.uid_to_indices[u]]
    assert not set(train_indices) & set(val_indices)

    train = RecSubset(dataset, train_indices, train_aug)
    n_extra_classes = 0
    if extra_dataset_dir is not None and Path(extra_dataset_dir).exists():
        extra = RecDataset(Path(extra_dataset_dir), None, 3,
                           init_dataset_method=simple_init_dataset,
                           start_class=len(train_users))
        n_extra_classes = len(extra.get_users())
        train = ConcatDataset((train, RecSubset(extra, list(range(len(extra))), train_aug)))
    val = RecSubset(dataset, val_indices, val_aug)
    # the training identities relabelled contiguously from 0
    for a, b in enumerate(train_users):
        dataset.label_map[b] = a

    pair_gen = PairGenerator(dataset, n_pairs, 1, None, seed, val_users)
    num_classes = len(train_users) + n_extra_classes
    steps_per_epoch = max(len(train) // train_batch_size, 1)

    def model():
        return resnet50_embedder(embedding_dim=emb_size)

    def loss(config, m):
        return SoftmaxBasedMetricLearning(model=m, emb_size=emb_size, num_classes=num_classes,
                                          margin_type="arc", use_focal=True)

    def optimizer(config):
        milestones = [35 * steps_per_epoch, 45 * steps_per_epoch]
        if optimizer_kind == "adamw":
            return partial(fe_adamw_optimizer, lr=lr or 1e-4, milestones_steps=milestones)
        return partial(fe_sgd_optimizer, lr=lr or 1e-2, milestones_steps=milestones)

    def train_dataloader():
        return DataLoader(train, train_batch_size, shuffle=True, seed=seed, drop_last=True,
                          num_workers=num_workers)

    def val_dataloader():
        return DataLoader(val, test_batch_size, shuffle=False, drop_last=False,
                          num_workers=num_workers)

    def pair_generator(idx):
        if idx == 0:
            return "Val", pair_gen
        if idx == 1:
            return "Val 1", pair_gen
        raise Exception(idx)

    out = Path(output)
    out.mkdir(exist_ok=True)
    return dict(
        seed=seed, n_epochs=n_epochs,
        train_batch_size=train_batch_size, test_batch_size=test_batch_size,
        emb_size=emb_size, num_classes=num_classes,
        thrs=np.linspace(0.5, 0.99, 6),
        far_thr=[0.1, 0.05, 0.03, 0.01, 0.005, 0.001],
        k=[5, 10, 100],
        model=model, loss=loss, optimizer=optimizer,
        train_dataloader=train_dataloader, val_dataloader=val_dataloader,
        pair_generator=pair_generator,
        output=out, experiment_name=experiment_name, run_name=run_name, dataset=dataset,
    )


def build_mask_config(
    data_root: str = "../pets_datasets",
    seed: int = 123,
    n_epochs: int = 65,
    train_batch_size: int = 8,
    test_batch_size: int = 8,
    image_size: tuple[int, int] = (640, 640),
    max_boxes: int = 4,
    output: str = "results",
    num_workers: int = 8,
) -> dict:
    """Mask R-CNN body config (the JAX ``build_mask_config``, reference
    ``configs/mask/mask_rcnn_config.py``): Oxford-IIIT Pet under
    ``data_root/oxford-iiit-pet`` with the trimap's body box and mask, split
    80/20 by a ``RandomState(seed)`` permutation; the training view built
    with ``rotate=True``, which the mask route never reads (ROADMAP note 19),
    the validation view plain; masks letterboxed with the images; the
    ResNet-50-FPN Mask R-CNN with 2 classes and 3 detections an image; SGD
    lr 5e-3, momentum 0.9, weight decay 1e-4, the rate x 0.1 at epochs 40
    and 55; ``drop_last`` on both loaders.

    ``optimizer(config)`` returns the optimiser factory the controller calls
    with the model's parameters (``params -> (SGD, schedule)``)."""
    from .data_loading.oxford import OxfordIIITPet, OxfordSubset
    from .engine.detector_controller import mask_model

    base = OxfordIIITPet(Path(data_root) / "oxford-iiit-pet",
                         target_types=("body_bbox", "segmentation"))
    n = len(base)
    perm = np.random.RandomState(seed).permutation(n)
    split = int(n * 0.8)
    train_ds = OxfordSubset(base, perm[:split].tolist(), rotate=True, seed=seed)
    val_ds = OxfordSubset(base, perm[split:].tolist())
    collate = DetectionCollate(image_size, max_boxes=max_boxes, with_masks=True)

    def optimizer(config):
        steps = max(split // train_batch_size, 1)
        return partial(detection_sgd_optimizer, lr=5e-3,
                       milestones_steps=[40 * steps, 55 * steps])

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
        model=mask_model, optimizer=optimizer,
        train_dataloader=train_dataloader, val_dataloader=val_dataloader,
        output=out, experiment_name="Detection", run_name="mask_rcnn",
    )


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
    weight decay 1e-4, the rate x 0.1 at epochs 18 and 23. Each pair of
    dog-annotation pickles (``paths.pickle`` / ``others.pickle``,
    ``paths2.pickle`` / ``others2.pickle``) found in ``fixtures_dir`` adds a
    ``SimpleDataset`` over ``data_root/data_25`` (rot90 drawn from its own
    ``RandomState(seed)``) after the CAT training part.

    ``optimizer(config)`` returns the optimiser factory the controller calls
    with the model's parameters (``params -> (SGD, schedule)``). ``arch``:
    ``"resnet50"`` (ResNet-50-FPN, frozen trunk statistics) or ``"mobile"``
    (MobileNetV3-Large with live BatchNorm at momentum 0.9)."""
    import pickle

    from .engine.detector_controller import keypoint_model

    cat_dir = Path(data_root) / "CAT_DATASET"
    if not cat_dir.exists():
        cat_dir = Path(data_root) / "cats"
    base = CatLMDDataset(cat_dir)
    n = len(base)
    perm = np.random.RandomState(seed).permutation(n)
    split = int(n * 0.8)
    train_ds = CatLMDSubset(base, perm[:split].tolist(), rotate90=True, seed=seed)
    val_ds = CatLMDSubset(base, perm[split:].tolist())
    extra_parts = []
    for pa, ot in DOG_FIXTURES:
        pa_p, ot_p = Path(fixtures_dir) / pa, Path(fixtures_dir) / ot
        if pa_p.exists() and ot_p.exists():
            with open(pa_p, "rb") as f:
                paths = pickle.load(f)
            with open(ot_p, "rb") as f:
                others = pickle.load(f)
            extra_parts.append(SimpleDataset(Path(data_root) / "data_25", paths, others,
                                             rotate90=True, rng=np.random.RandomState(seed)))
    if extra_parts:
        train_ds = ConcatDataset([train_ds, *extra_parts])
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
