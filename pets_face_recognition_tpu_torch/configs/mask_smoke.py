"""Mask R-CNN training smoke (the JAX ``configs/smoke/mask_smoke.py``): the
production ResNet-50-FPN Mask R-CNN recipe on a seeded Oxford-IIIT Pet
miniature (``smoke_data.make_oxford``: 40 photos of 320 x 320 with 8-bit
grey trimaps, written with the port's own JPEG and PNG encoders under
``PFR_SMOKE_ROOT``, default ``results_smoke/oxford`` in the working
directory), B = 4 at 320 x 320, 2 box slots, 2 loader threads,
``PFR_SMOKE_EPOCHS`` epochs (1):

    python -m pets_face_recognition_tpu_torch.main_detection \\
        --config pets_face_recognition_tpu_torch/configs/mask_smoke.py [--device cpu]
"""

import os
from pathlib import Path

from pets_face_recognition_tpu_torch.config_presets import build_mask_config
from pets_face_recognition_tpu_torch.smoke_data import make_oxford

_root = Path(os.environ.get("PFR_SMOKE_ROOT", "results_smoke/oxford"))
if not (_root / "oxford-iiit-pet").exists():
    make_oxford(_root)

globals().update(build_mask_config(
    data_root=str(_root),
    n_epochs=int(os.environ.get("PFR_SMOKE_EPOCHS", 1)),
    train_batch_size=4,
    test_batch_size=4,
    image_size=(320, 320),
    max_boxes=2,
    num_workers=2,
    output="results_smoke",
))
