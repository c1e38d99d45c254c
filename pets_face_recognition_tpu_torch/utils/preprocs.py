"""The feature extractor's augmentation (counterpart of the JAX
``utils/preprocs.py::FETrainAug`` and ``FEValAug``) in numpy, without PIL.

The JAX transform runs PIL 12's operations on a uint8 RGB image; each is
rewritten here with PIL's own arithmetic so that the result is bit-equal:

- :func:`smooth`: ``ImageEnhance.Sharpness(0.0)``, which is the 3 x 3 SMOOTH
  filter (1 1 1 / 1 5 1 / 1 1 1 over 13) in float32 with the border pixels
  copied and the sum truncated after adding 0.5;
- :func:`autocontrast`: ``ImageOps.autocontrast``'s lookup table per band,
  ``int(i * 255 / (hi - lo) - lo * scale)`` clamped to [0, 255] in Python
  floats;
- :func:`resize_bilinear`: ``Image.resize(BILINEAR)``, the separable
  resample with triangle weights normalised in float64, turned into 22-bit
  fixed point, a horizontal pass rounded to uint8, then a vertical one;
- :func:`rotate_nearest`: ``Image.rotate(angle, NEAREST)``, the inverse
  affine map about the image centre with its coefficients rounded to 15
  decimals, walked in 16.16 fixed point from the pixel centres; outside is 0.

``FETrainAug`` draws from its ``RandomState`` in the JAX order: sharpness
(10%), autocontrast (30%), the crop's corner, the angle.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def smooth(img: np.ndarray) -> np.ndarray:
    """PIL's ``ImageFilter.SMOOTH`` on ``(H, W, C)`` uint8."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()
    k1, k5 = np.float32(1.0 / 13.0), np.float32(5.0 / 13.0)
    f = img.astype(np.float32)

    def row(r, kc):      # in[x-1] * k0 + in[x] * k1 + in[x+1] * k2, left to right
        return (r[:, :-2] * k1 + r[:, 1:-1] * kc) + r[:, 2:] * k1

    ss = np.float32(0.5)                          # the filter's offset + rounding
    ss = ss + row(f[2:], k1)                      # the row below first, as PIL
    ss = ss + row(f[1:-1], k5)
    ss = ss + row(f[:-2], k1)
    out = img.copy()
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def autocontrast(img: np.ndarray) -> np.ndarray:
    """PIL's ``ImageOps.autocontrast()`` (cutoff 0) on ``(H, W, C)`` uint8."""
    img = np.asarray(img, np.uint8)
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        band = img[..., c]
        lo, hi = int(band.min()), int(band.max())
        if hi <= lo:
            out[..., c] = band
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        lut = np.array([min(max(int(i * scale + offset), 0), 255) for i in range(256)],
                       np.uint8)
        out[..., c] = lut[band]
    return out


PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter over the whole input: ``(xmin (out,), weights (out, ksize)
    int32)``; the weights of an output sum to ~2^22, so a sum of taps times
    weights stays inside int32."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(w)      # float64, in order
        w = [v / ww if ww != 0.0 else v for v in w]
        xmins[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    shape = (-1,) + (1,) * (src.ndim - 1)
    ss = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):                       # one tap at a time
        ss += src[np.minimum(xmins + k, in_size - 1)] * kk[:, k].reshape(shape)
    out = np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's ``resize((w, h), BILINEAR)`` on ``(H, W, C)`` uint8;
    ``size = (w, h)`` as PIL takes it."""
    img = np.asarray(img, np.uint8)
    w, h = size
    if img.shape[1] != w:
        img = _resample_axis(img, w, axis=1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, axis=0)
    return img


def rotate_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's ``rotate(angle, NEAREST)`` (counter-clockwise in degrees, about
    the centre, same size, zero outside) on ``(H, W, C)`` uint8."""
    img = np.asarray(img, np.uint8)
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.rot90(img, 1 if angle == 90 else 3).copy()
    cx, cy = w / 2.0, h / 2.0
    rad = -math.radians(angle)
    a, b, d, e = (round(math.cos(rad), 15), round(math.sin(rad), 15),
                  round(-math.sin(rad), 15), round(math.cos(rad), 15))
    c = a * -cx + b * -cy + cx
    f = d * -cx + e * -cy + cy

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(a), fix(b), fix(d), fix(e)
    a2 = fix(c + a * 0.5 + b * 0.5)
    a5 = fix(f + d * 0.5 + e * 0.5)
    ys, xs = np.arange(h, dtype=np.int64)[:, None], np.arange(w, dtype=np.int64)[None, :]
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[inside] = img[yin[inside], xin[inside]]
    return out


class FETrainAug:
    """FE training augmentation (the reference compose of
    ``configs/cat_fe/cat_fe_head.py``): 10% sharpness 0 (the SMOOTH blur),
    30% autocontrast, a random ``crop`` x ``crop`` window, a bilinear resize
    to ``size``, a nearest rotation by U(-degrees, degrees); returns float32
    HWC in [0, 1]."""

    def __init__(self, rng: np.random.RandomState | None = None, crop: int = 220,
                 size: int = 224, degrees: float = 5.0):
        self.rng = rng or np.random.RandomState()
        self.crop = crop
        self.size = size
        self.degrees = degrees

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        img = np.asarray(img, np.uint8)
        if rng.rand() < 0.1:
            img = smooth(img)
        if rng.rand() < 0.3:
            img = autocontrast(img)
        h, w = img.shape[:2]
        if w >= self.crop and h >= self.crop:
            x0 = rng.randint(0, w - self.crop + 1)
            y0 = rng.randint(0, h - self.crop + 1)
            img = img[y0:y0 + self.crop, x0:x0 + self.crop]
        img = resize_bilinear(img, (self.size, self.size))
        img = rotate_nearest(img, rng.uniform(-self.degrees, self.degrees))
        return img.astype(np.float32) / 255.0


class FEValAug:
    """FE validation transform: ToTensor semantics (float32 [0, 1], HWC)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return np.asarray(img, np.float32) / 255.0
