"""Dog head FE, SGD (the JAX ``configs/dog_fe/fe_dogs_config.py``): as
``cat_fe_head.py`` over the dog corpora."""

from pets_face_recognition_tpu_torch.config_presets import build_fe_config

globals().update(build_fe_config(
    dataset_dir="../pets_datasets/data_25_transformed_v6_dogs",
    extra_dataset_dir="../pets_datasets/petfinder_extra_dogs_transformed_v6",
    optimizer_kind="sgd",
    experiment_name="Dogs",
    run_name="ResNet50 datasetv6 dog head SGD",
))
