"""Train the Mask R-CNN body detector (counterpart of the JAX
``main_detection.py``):

    python -m pets_face_recognition_tpu_torch.main_detection \\
        --config pets_face_recognition_tpu_torch/configs/mask_rcnn_config.py [--device cpu]
"""

from .engine.detector_controller import DetectionController
from .main import main

if __name__ == "__main__":
    main(DetectionController)
