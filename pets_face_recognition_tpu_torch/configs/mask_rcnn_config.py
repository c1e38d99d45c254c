"""Mask R-CNN body detector (the JAX ``configs/mask/mask_rcnn_config.py``):
Oxford-IIIT Pet under ``../pets_datasets/oxford-iiit-pet``, trimap body boxes
and masks, ResNet-50-FPN, num_classes=2, 3 detections an image, B = 8 at
640 x 640, 4 box slots, 65 epochs."""

from pets_face_recognition_tpu_torch.config_presets import build_mask_config

globals().update(build_mask_config())
