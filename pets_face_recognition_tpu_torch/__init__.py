"""PyTorch/CUDA port of ``pets_face_recognition_tpu`` (detect -> align -> embed).

The JAX package beside this one is the reference; every module here mirrors the
module of the same name there and is held against it by
``tests/test_torch_port_*.py``. The three Pallas kernels of the serving path are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at first
use (``kernels/_build.py``). This package imports ``torch`` and numpy only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
