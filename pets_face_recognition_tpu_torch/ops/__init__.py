"""Box, anchor, NMS, RoIAlign and homography ops (counterparts of the JAX ``ops/``)."""
