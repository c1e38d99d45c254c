"""Train the keypoint R-CNN head+landmark detector (counterpart of the JAX
``main_keypoints.py``):

    python -m pets_face_recognition_tpu_torch.main_keypoints \\
        --config pets_face_recognition_tpu_torch/configs/keypoints_config.py [--device cpu]
"""

from .engine.detector_controller import KeyPointsController
from .main import main

if __name__ == "__main__":
    main(KeyPointsController)
