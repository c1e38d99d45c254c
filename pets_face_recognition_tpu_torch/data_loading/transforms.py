"""Rotation of an image, its points and its boxes by an angle (counterpart of
the JAX ``data_loading/transforms.py``), in numpy on the host, bit-equal to
the cv2 calls the JAX package makes.

:func:`rotation_matrix` is ``cv2.getRotationMatrix2D``: the centre taken as
float32, the angle in radians through the C library's ``cos`` and ``sin``
(``math``, not numpy's vector versions). :func:`rotate_image` is
``cv2.warpAffine(..., INTER_NEAREST, BORDER_REFLECT_101)`` as OpenCV 5
computes it: the matrix inverted in float64 and rounded to float32, each
row's ``m1 * y + m2`` in float32, the column term added by one fused
multiply-add, the source position rounded half to even, and a position off
the image reflected about its edge pixel. A float ``floor(x + 0.5)`` or a
float64 position rounds other pixels along the diagonals; the fixed-point
map of OpenCV 4 (positions in 1/1024, half a unit added before the shift)
rounds others again. Boxes rotate by enclosing their rotated corners (the
albumentations ``bbox_rotate`` the reference uses).
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def rotation_matrix(center: tuple[float, float], angle: float, scale: float = 1.0
                    ) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: ``(2, 3)`` float64,
    counter-clockwise by ``angle`` degrees about ``center`` (x, y)."""
    cx, cy = (float(_F32(c)) for c in center)     # cv::Point2f
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _center(h: int, w: int) -> tuple[float, float]:
    return (w / 2 - 0.5, h / 2 - 0.5)


def _inverse(m: np.ndarray) -> list[float]:
    """warpAffine's inversion of the forward map, in its order of operations."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the float32 product is exact in
    float64, and the sum rounds to float32 as a fused multiply-add does
    (save a float64 rounding that lands on a float32 tie, which the
    positions of an image never reach)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F32)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    """``cv::borderInterpolate(p, n, BORDER_REFLECT_101)``."""
    if n == 1:
        return np.zeros_like(p)
    while True:
        out = (p < 0) | (p >= n)
        if not out.any():
            return p
        p = np.where(p < 0, -p, np.where(p >= n, 2 * (n - 1) - p, p))


def warp_affine_nearest(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_NEAREST,
    borderMode=BORDER_REFLECT_101)`` for an ``(h, w)`` or ``(h, w, C)``
    image: each output pixel takes the source pixel nearest to its inverse
    map."""
    h, w = img.shape[:2]
    mi = [_F32(v) for v in _inverse(m)]
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    row_x = mi[1] * ys + mi[2]                    # float32, per row
    row_y = mi[4] * ys + mi[5]
    sx = np.rint(_fma32(mi[0], xs, row_x)).astype(np.int64)
    sy = np.rint(_fma32(mi[3], xs, row_y)).astype(np.int64)
    return img[_reflect101(sy, h), _reflect101(sx, w)]


def rotate_image(img: np.ndarray, angle: float) -> np.ndarray:
    """``img`` turned counter-clockwise by ``angle`` degrees about its centre
    on a canvas of the same size, nearest pixel, reflected border."""
    h, w = img.shape[:2]
    return warp_affine_nearest(img, rotation_matrix(_center(h, w), angle, 1.0))


def rotate_points(pts: np.ndarray, angle: float, hw: tuple[int, int]) -> np.ndarray:
    """``(N, 2)`` (x, y) points turned as :func:`rotate_image` turns the image."""
    h, w = hw
    m = rotation_matrix(_center(h, w), angle, 1.0)
    pts = np.asarray(pts, float)
    ones = np.ones((len(pts), 1))
    return (np.concatenate([pts, ones], axis=1) @ m.T).astype(float)


def rotate_bbox(bbox: np.ndarray, angle: float, hw: tuple[int, int]) -> np.ndarray:
    """An xyxy box turned as the image: the box enclosing its turned corners."""
    x1, y1, x2, y2 = np.asarray(bbox, float)
    corners = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])
    rc = rotate_points(corners, angle, hw)
    return np.array([rc[:, 0].min(), rc[:, 1].min(), rc[:, 0].max(), rc[:, 1].max()])
