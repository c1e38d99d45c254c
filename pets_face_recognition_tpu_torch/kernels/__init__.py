"""Hand-written CUDA kernels: build, load and launch bookkeeping.

``library()`` builds ``csrc/*.cu`` with one ``nvcc`` call at first use and loads
the shared library with ``ctypes`` (see ``_build.py``). Each kernel wrapper
(in ``ops/``) launches through :func:`launch`, which adds one to the wrapper's
entry in the launch counts every time it launches its kernel, and nowhere else,
so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import torch

from ._build import build, library

# K1 and K3 count each compute mode under its own name: ``warp_perspective_batch``
# is K1 in float32, ``_bf16`` and ``_int8`` its reduced-precision modes;
# ``multilevel_roi_align_bf16`` is K3 on bfloat16 levels and
# ``multilevel_roi_align_backward_bf16`` K4 with bfloat16 operands
KERNELS = ("warp_perspective_batch", "warp_perspective_batch_bf16",
           "warp_perspective_batch_int8", "nms_keep_sorted_batch", "nms_keep_sorted",
           "nms_keep_sorted_grid", "multilevel_roi_align", "multilevel_roi_align_bf16",
           "roi_footprints", "multilevel_roi_align_backward",
           "multilevel_roi_align_backward_bf16")

_launches = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Call ``symbol`` of the kernel library with ``args`` and, last, the raw
    handle of ``device``'s current stream, with ``device`` current; raise if the
    launch failed; count one launch of ``name``.

    Host time matters for small kernels such as K1's: the raw stream handle
    costs far less than building a ``torch.cuda.Stream`` object, and the device
    guard is entered only when another device is current.
    """
    fn = getattr(library(), symbol)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
    _launches[name] += 1


def check_cuda(name: str, t: torch.Tensor, shape_rank: int,
               dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given rank whose
    dtype is one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != shape_rank:
        raise ValueError(f"{name}: expected rank {shape_rank}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_cuda_f32(name: str, t: torch.Tensor, shape_rank: int) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of the given rank."""
    check_cuda(name, t, shape_rank)


__all__ = ["KERNELS", "build", "library", "reset_launch_counts",
           "launch_counts", "launch", "check_cuda", "check_cuda_f32"]
