"""Hand-written CUDA kernels: build, load and launch bookkeeping.

``library()`` builds ``csrc/*.cu`` with one ``nvcc`` call at first use and loads
the shared library with ``ctypes`` (see ``_build.py``). Each kernel wrapper
(in ``ops/``) adds one to its entry in the launch counts every time it launches
its kernel, and nowhere else, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import build, library

KERNELS = ("warp_perspective_batch", "nms_keep_sorted_batch", "nms_keep_sorted",
           "nms_keep_sorted_grid", "multilevel_roi_align",
           "multilevel_roi_align_backward")

_launches = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def count_launch(name: str) -> None:
    _launches[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda_f32(name: str, t: torch.Tensor, shape_rank: int) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of the given rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != shape_rank:
        raise ValueError(f"{name}: expected rank {shape_rank}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


__all__ = ["KERNELS", "build", "library", "reset_launch_counts",
           "launch_counts", "count_launch", "ptr", "stream_of",
           "check_cuda_f32", "raise_on_error"]
