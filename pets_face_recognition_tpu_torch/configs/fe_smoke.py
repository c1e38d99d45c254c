"""FE training smoke (the JAX ``configs/smoke/fe_smoke.py``): the production
ResNet-50 -> 512-d ArcFace recipe on seeded synthetic identity cards
(``smoke_data.make_fe``: 16 identities of 6 crops of 224 x 224, written with
the port's own JPEG encoder under ``PFR_SMOKE_ROOT``, default
``results_smoke/fe_data`` in the working directory), B = 16, test B = 8, 2
loader threads, ``PFR_SMOKE_EPOCHS`` epochs (2), ``PFR_SMOKE_PAIRS`` pairs
(200):

    python -m pets_face_recognition_tpu_torch.main \\
        --config pets_face_recognition_tpu_torch/configs/fe_smoke.py [--device cpu]
"""

import os
from pathlib import Path

from pets_face_recognition_tpu_torch.config_presets import build_fe_config
from pets_face_recognition_tpu_torch.smoke_data import make_fe

_root = Path(os.environ.get("PFR_SMOKE_ROOT", "results_smoke/fe_data"))
if not (_root / "smoke_fe_cats").exists():
    make_fe(_root)

globals().update(build_fe_config(
    dataset_dir=str(_root / "smoke_fe_cats"),
    n_epochs=int(os.environ.get("PFR_SMOKE_EPOCHS", 2)),
    train_batch_size=16,
    test_batch_size=8,
    num_workers=2,
    experiment_name="Smoke",
    run_name="ResNet50 FE smoke",
    output="results_smoke",
    n_pairs=int(os.environ.get("PFR_SMOKE_PAIRS", 200)),
))
