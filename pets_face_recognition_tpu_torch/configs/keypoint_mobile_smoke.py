"""MobileNetV3-Large keypoint R-CNN training smoke on the committed
CAT_DATASET miniature (40 photos of 320 x 320), the JAX
``configs/smoke/keypoint_mobile_smoke.py`` recipe: the mobile detector with
live BatchNorm (momentum 0.9), B = 4 at 320 x 320, 2 boxes, 2 loader
threads, ``PFR_SMOKE_EPOCHS`` epochs (1), output under ``results_smoke``:

    python -m pets_face_recognition_tpu_torch.main_keypoints \\
        --config pets_face_recognition_tpu_torch/configs/keypoint_mobile_smoke.py [--device cpu]

Its checkpoint feeds ``recalibrate_bn`` (precise BN) and the mobile rows of
``quality_instrument`` (``--mobile-ckpt <run>/checkpoints``).
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
    arch="mobile",
))
