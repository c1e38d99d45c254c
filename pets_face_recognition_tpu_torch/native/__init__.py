"""Native JPEG decode + letterbox, and JPEG encode (counterpart of the JAX
``native/``), built with ``g++`` at first use and loaded with ``ctypes``;
PNG in :mod:`.png`.

Two routes export one C ABI (``pfr_decode_batch``, ``pfr_decode_single``,
``pfr_encode_jpeg``) and share the letterbox code (``pfr_common.h``):

- ``libjpeg`` (``pfr_native.cpp``, the JAX package's decoder): libjpeg on a
  thread pool, with its DCT-domain downscale for large photos; the encoder is
  PIL's default save (libjpeg's defaults: 4:2:0, integer DCT);
- ``nvjpeg`` (``pfr_nvjpeg.cpp``): the CUDA toolkit's nvJPEG decodes and
  encodes on the GPU, the host letterboxes. Pixels may differ from libjpeg's
  by a few levels, both ways.

:func:`route` picks by what is installed, never by catching a failure:
``libjpeg`` where ``g++`` and ``jpeglib.h`` are found, else ``nvjpeg`` where
``g++`` and the toolkit's ``nvjpeg.h`` are, else none (callers then read
images with PIL). Once a route is chosen, a failed build raises. The library
goes to the git-ignored ``_build/`` beside the package, named by a hash of
its sources and flags, as ``kernels/_build.py`` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR, find_nvcc

HERE = Path(__file__).resolve().parent
SOURCES = {"libjpeg": "pfr_native.cpp", "nvjpeg": "pfr_nvjpeg.cpp"}
INCLUDE_DIRS = ("/usr/include", "/usr/local/include")
BUILD_TIMEOUT_S = 300


def _include_dirs() -> list[Path]:
    extra = [p for var in ("CPATH", "CPLUS_INCLUDE_PATH", "C_INCLUDE_PATH")
             for p in os.environ.get(var, "").split(os.pathsep) if p]
    return [Path(p) for p in (*extra, *INCLUDE_DIRS)]


def cuda_root() -> Path | None:
    """The CUDA toolkit's root: the folder above ``nvcc``'s ``bin/``."""
    nvcc = find_nvcc()
    return Path(nvcc).resolve().parent.parent if nvcc else None


@functools.cache
def route() -> str | None:
    """``"libjpeg"``, ``"nvjpeg"`` or ``None``: what this host can build."""
    if shutil.which("g++") is None:
        return None
    if any((d / "jpeglib.h").is_file() for d in _include_dirs()):
        return "libjpeg"
    root = cuda_root()
    if root is not None and (root / "include" / "nvjpeg.h").is_file():
        return "nvjpeg"
    return None


def is_available() -> bool:
    return route() is not None


def build_command(name: str, out: Path) -> list[str]:
    src = HERE / SOURCES[name]
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", str(src),
           "-o", str(out)]
    if name == "libjpeg":
        return cmd + ["-ljpeg", "-lpthread"]
    root = cuda_root()
    lib = root / "lib64"
    # cudart linked statically: the process's other CUDA runtimes (torch's,
    # the kernels') are of other versions
    return cmd + [f"-I{root / 'include'}", f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg",
                  "-lcudart_static", "-ldl", "-lrt", "-lpthread"]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(build_command(name, Path("out"))).encode())
    for src in (SOURCES[name], "pfr_common.h"):
        h.update((HERE / src).read_bytes())
    return BUILD_DIR / f"libpfr_native_{name}_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build this host's route unless its library exists; return its path.
    Raises ``RuntimeError`` when no route is installed or ``g++`` fails."""
    name = route()
    if name is None:
        raise RuntimeError("no native JPEG route: needs g++ and jpeglib.h, or g++ and "
                           "the CUDA toolkit's nvjpeg.h")
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = build_command(name, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {shlex.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The route's library, built and loaded once a process; safe to call
    from many threads at once (a loader's workers do)."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.pfr_decode_batch.restype = ctypes.c_int
    lib.pfr_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.pfr_decode_single.restype = ctypes.c_int
    lib.pfr_decode_single.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.pfr_encode_jpeg.restype = ctypes.c_long
    lib.pfr_encode_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_long]
    return lib


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """An ``(H, W, 3)`` uint8 RGB image as baseline JPEG bytes at ``quality``
    with 4:2:0 chroma (PIL's ``save`` defaults at quality 75). Raises
    ``RuntimeError`` if the encoder fails; there is no fallback."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not {img.shape}")
    h, w = img.shape[:2]
    lib = library()
    capacity = img.size + (1 << 16)
    for _ in range(2):
        out = np.empty(capacity, np.uint8)
        n = lib.pfr_encode_jpeg(img.ctypes.data, w, h, int(quality), out.ctypes.data, capacity)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            break
        capacity = -n
    raise RuntimeError(f"JPEG encode failed ({route()} route, {w} x {h})")


def write_jpeg(path: str | Path, img: np.ndarray, quality: int = 75) -> None:
    Path(path).write_bytes(encode_jpeg(img, quality))


def decode_batch(paths: list[str | Path], out_size: tuple[int, int], num_threads: int = 0
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode and letterbox a batch of JPEGs on the native thread pool.

    Returns ``(images (N, H, W, 3) uint8, ok (N,) bool, scales (N,) float32,
    pads (N, 2) float32)``, the geometry of ``utils.collate.letterbox_image``;
    a file that does not decode has ``ok`` False and a zero image.
    """
    lib = library()
    H, W = out_size
    n = len(paths)
    images = np.zeros((n, H, W, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    scales = np.zeros(n, np.float32)
    pads = np.zeros((n, 2), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.pfr_decode_batch(c_paths, n, images.ctypes.data, W, H, ok.ctypes.data,
                         scales.ctypes.data, pads.ctypes.data, num_threads)
    return images, ok.astype(bool), scales, pads


def decode_single(path: str | Path, target_min_side: int = 0) -> np.ndarray | None:
    """Decode one JPEG to an ``(H, W, 3)`` uint8 array; ``None`` if it does not
    decode. ``target_min_side > 0`` lets the libjpeg route downscale in the DCT
    domain while the short side stays at least that long."""
    lib = library()
    w, h = ctypes.c_int(), ctypes.c_int()
    p = os.fsencode(path)
    if not lib.pfr_decode_single(p, None, ctypes.byref(w), ctypes.byref(h), target_min_side):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if not lib.pfr_decode_single(p, out.ctypes.data, ctypes.byref(w), ctypes.byref(h),
                                 target_min_side):
        return None
    return out


# start-of-frame markers (baseline, extended, progressive, lossless, ...):
# 0xC0-0xCF but DHT (0xC4), JPG (0xC8) and DAC (0xCC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_components(path: str | Path) -> int:
    """The number of colour components of a JPEG (1 gray, 3 YCbCr, 4 CMYK),
    read from its start-of-frame header; 0 if none is found before the scan."""
    data = Path(path).read_bytes()
    i = 2                                     # after SOI
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return 0
        marker = data[i + 1]
        if marker == 0xFF:                    # fill byte
            i += 1
            continue
        if marker in _SOF:
            return data[i + 9] if i + 9 < len(data) else 0
        if marker == 0xDA:                    # start of scan: no frame header
            return 0
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            i += 2                            # markers without a length
            continue
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return 0



def read_rgb(path: str | Path) -> np.ndarray:
    """A JPEG or PNG file as ``(H, W, 3)`` uint8 RGB (PIL's
    ``open(path).convert("RGB")``), told apart by their signatures, not the
    name; ``OSError`` if it is neither or does not decode."""
    from . import png

    with open(path, "rb") as f:
        magic = f.read(8)
    try:
        if magic == png.SIGNATURE:
            return png.read_png(path)
    except (ValueError, zlib.error) as e:
        raise OSError(f"cannot decode {path}: {e}") from e
    if magic[:2] == b"\xff\xd8":
        img = decode_single(path)
        if img is not None:
            return img
    raise OSError(f"cannot decode {path}")
