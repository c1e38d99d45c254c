"""Keypoint R-CNN head+landmarks (the JAX ``configs/keypoint/keypoints_config.py``):
CAT_DATASET 3 landmarks under ``../pets_datasets``, ResNet-50-FPN,
num_classes=2, 1 detection an image, B = 16 at 640 x 640, 25 epochs."""

from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config

globals().update(build_keypoint_config())
