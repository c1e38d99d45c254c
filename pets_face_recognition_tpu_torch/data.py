"""Seeded synthetic keypoint-detection batches to the JAX batch contract
(``engine/detector_controller.py``): ``images (B, H, W, 3)`` float32 in
[0, 1], ``boxes (B, G, 4)`` xyxy float32, ``labels (B, G)`` int32 (0, the
first foreground class before the controller's +1 shift), ``valid (B, G)``
bool and ``keypoints (B, G, 3, 3)`` (x, y, visibility) inside their boxes.
Image ``b`` has ``1 + b % G`` valid boxes; the rest are zero padding."""

from __future__ import annotations

import numpy as np


def synthetic_keypoint_batch(B: int, H: int, W: int, G: int, seed: int = 0,
                             num_keypoints: int = 3) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    images = rng.rand(B, H, W, 3).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    keypoints = np.zeros((B, G, num_keypoints, 3), np.float32)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        for g in range(1 + b % G):
            w = rng.uniform(0.15, 0.5) * W
            h = rng.uniform(0.15, 0.5) * H
            x1 = rng.uniform(0, W - w)
            y1 = rng.uniform(0, H - h)
            boxes[b, g] = (x1, y1, x1 + w, y1 + h)
            keypoints[b, g, :, 0] = x1 + rng.uniform(0.1, 0.9, num_keypoints) * w
            keypoints[b, g, :, 1] = y1 + rng.uniform(0.1, 0.9, num_keypoints) * h
            keypoints[b, g, :, 2] = 1.0
            valid[b, g] = True
    return {"images": images, "boxes": boxes, "labels": np.zeros((B, G), np.int32),
            "valid": valid, "keypoints": keypoints}
