"""Cat head FE, SGD (the JAX ``configs/cat_fe/cat_fe_head.py``): the aligned
head crops of data_25 (v6) and the petfinder extras under
``../pets_datasets``, ResNet-50 -> 512-d with ArcFace, B = 64 at 224 x 224,
50 epochs:

    python -m pets_face_recognition_tpu_torch.main \\
        --config pets_face_recognition_tpu_torch/configs/cat_fe_head.py [--device cpu]
"""

from pets_face_recognition_tpu_torch.config_presets import build_fe_config

globals().update(build_fe_config(
    dataset_dir="../pets_datasets/data_25_transformed_v6_cats",
    extra_dataset_dir="../pets_datasets/petfinder_extra_cats_transformed_v6",
    optimizer_kind="sgd",
    experiment_name="Cats",
    run_name="ResNet50 datasetv6 cat head SGD",
))
