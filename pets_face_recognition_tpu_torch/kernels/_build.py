"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it.

One ``nvcc`` call compiles every source for ``sm_90a`` into a plain-C shared
library; nothing includes PyTorch's headers and nothing goes through
``torch.utils.cpp_extension`` or ninja, so the build takes seconds. The output
is named by a hash of the sources and flags and lives in ``_build/`` beside
the package (git-ignored). It is written under a temporary name and then
``os.replace``d, so a half-written library is never loaded. ``library()``
builds on first use and loads with ``ctypes``; every pointer and the stream
are ``c_void_p`` in ``argtypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str | None:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpfr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources already exists.

    Returns the library's path. Raises ``RuntimeError`` with the command when
    ``nvcc`` is missing or fails.
    """
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    nvcc = find_nvcc()
    cmd = [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sources())]
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
            f"the kernel build would run: {shlex.join(cmd)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {shlex.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        if proc.stderr.strip():
            print(proc.stderr.strip(), flush=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # (src, hs, out, B, H, W, C, OH, OW, stream)
    "pfr_warp_perspective_batch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (boxes, valid, words, keep, G, K, iou_threshold, stream)
    "pfr_nms_keep_sorted_batch": (_P, _P, _P, _P, _I, _I, _F, _P),
    # (p0..p3, H0..H3, W0..W3, stride0..stride3, n_levels, C,
    #  rois, batch_idx, level, K, OH, OW, sampling_ratio, out, stream)
    "pfr_multilevel_roi_align": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                                 _I, _I, _I, _P, _P),
    # (rois, batch_idx, level, H0..H3, W0..W3, stride0..stride3, n_levels, B, K,
    #  OH, OW, sampling_ratio, key, footprint, stream)
    "pfr_roi_footprints": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # (g, d0..d3, H0..H3, W0..W3, stride0..stride3, n_levels, B, C,
    #  rois, order, footprint, group_start, OH, OW, sampling_ratio, stream)
    "pfr_multilevel_roi_align_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                          _P, _P, _I, _I, _I, _P),
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
