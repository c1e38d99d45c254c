"""Keypoint R-CNN training smoke on the committed CAT_DATASET miniature (40
photos of 320 x 320 in the CAT layout, ``tools/make_smoke_datasets.py::
make_cat_dataset(n_imgs=40, seed=1)``), the JAX ``configs/smoke/
keypoint_smoke.py`` recipe: the production ResNet-50-FPN model, B = 4 at
320 x 320, 2 boxes, 2 loader threads, ``PFR_SMOKE_EPOCHS`` epochs (1):

    python -m pets_face_recognition_tpu_torch.main_keypoints \\
        --config pets_face_recognition_tpu_torch/configs/keypoint_smoke.py [--device cpu]
"""

import os
from pathlib import Path

from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config

globals().update(build_keypoint_config(
    data_root=str(Path(__file__).resolve().parent.parent / "testdata"),
    n_epochs=int(os.environ.get("PFR_SMOKE_EPOCHS", 1)),
    train_batch_size=4,
    test_batch_size=4,
    image_size=(320, 320),
    max_boxes=2,
    num_workers=2,
    output="results_smoke",
))
