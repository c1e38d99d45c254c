"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it.

``nvcc`` compiles every source for ``sm_90a``, one process a source, all
started together, and links the objects into a plain-C shared library;
nothing includes PyTorch's headers and nothing goes through
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
              "-Xcompiler", "-fPIC")
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

    One ``nvcc -c`` a source, all started together, then one ``nvcc -shared``
    link. Returns the library's path. Raises ``RuntimeError`` with the
    commands when ``nvcc`` is missing or fails.
    """
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    nvcc = find_nvcc() or "nvcc"
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if find_nvcc() is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the kernel "
            f"build would run: {'; '.join(map(shlex.join, compiles + [link]))}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        results = []
        for cmd, proc in zip(compiles, procs):
            try:
                stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise
            results.append((cmd, proc.returncode, stdout, stderr))
        proc = subprocess.run(link, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S) \
            if all(rc == 0 for _, rc, _, _ in results) else None
        if proc is not None:
            results.append((link, proc.returncode, proc.stdout, proc.stderr))
        for cmd, rc, stdout, stderr in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {shlex.join(cmd)}\n{stdout}\n{stderr}")
            if stderr.strip():
                print(stderr.strip(), flush=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # (src, hs, out, B, H, W, C, OH, OW, out_bf16, stream), one symbol a mode
    "pfr_warp_perspective_batch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "pfr_warp_perspective_batch_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "pfr_warp_perspective_batch_int8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (slack): a test hook, the int8 instance's box widening for later launches
    "pfr_warp_int8_test_box_slack": (_I,),
    # (boxes, valid, words, keep, G, K, iou_threshold, stream)
    "pfr_nms_keep_sorted_batch": (_P, _P, _P, _P, _I, _I, _F, _P),
    # (p0..p3, H0..H3, W0..W3, stride0..stride3, n_levels, C, rois, batch_idx, K,
    #  OH, OW, sampling_ratio, canonical_scale, canonical_level, min_level, out,
    #  stream)
    "pfr_multilevel_roi_align": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                 _I, _I, _F, _I, _I, _P, _P),
    # the same over bfloat16 levels, with out_bf16 after out
    "pfr_multilevel_roi_align_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                      _I, _I, _F, _I, _I, _P, _I, _P),
    # (rois, batch_idx, H0..H3, W0..W3, stride0..stride3, n_levels, B, K,
    #  OH, OW, sampling_ratio, canonical_scale, canonical_level, min_level,
    #  key, footprint, stream)
    "pfr_roi_footprints": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P),
    # (g, d0..d3, H0..H3, W0..W3, stride0..stride3, n_levels, B, C,
    #  rois, order, footprint, group_start, OH, OW, sampling_ratio, stream)
    "pfr_multilevel_roi_align_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                          _P, _P, _I, _I, _I, _P),
    # K4 with bfloat16 operands: (g, g_bf16, d0..d3, out_bf16, then as above)
    "pfr_multilevel_roi_align_backward_bf16": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                               _P, _P, _P, _P, _I, _I, _I, _P),
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
