"""The feature extractor's augmentation and the body crop's letterbox
(counterpart of the JAX ``utils/preprocs.py::FETrainAug``, ``FEValAug``,
``padding`` and ``resize_with_padding``) in numpy, without PIL.

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
  decimals, walked in 16.16 fixed point from the pixel centres; outside is 0;
- :func:`resize_with_padding`: ``Image.thumbnail`` (PIL's aspect rounding,
  never enlarging; with ``reducing_gap=2.0`` a crop more than twice the
  target is first box-averaged by ``Image.reduce``'s integer factors, each
  block's sum scaled by a float32-derived multiplier, and the resize then
  reads the reduced image through a fractional float32 box) with the
  bicubic filter (a = -0.5) in the same fixed point as the bilinear one,
  then ``ImageOps.expand``'s centred black pad (:func:`padding`).

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


def _bilinear_filter(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def _bicubic_filter(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# PIL's filters and their supports
FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int, kind: str = "bilinear", in0: float = 0.0,
            in1: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the filter
    ``kind`` over the input box ``[in0, in1)`` (float32, as PIL passes it;
    the whole input by default): ``(xmin (out,), weights (out, ksize)
    int32)``; the weights of an output sum to ~2^22, so a sum of taps times
    weights stays inside int32."""
    filt, filter_support = FILTERS[kind]
    in0 = np.float32(in0)
    in1 = np.float32(in_size if in1 is None else in1)
    scale = float(in1 - in0) / out_size          # the float32 difference, in double
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = float(in0) + (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)      # float64, in order
        w = [v / ww if ww != 0.0 else v for v in w]
        xmins[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str = "bilinear",
                   in0: float = 0.0, in1: float | None = None) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, kind, in0, in1)
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


def _reduce(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """PIL's ``Image.reduce((fx, fy))`` on ``(H, W, C)`` uint8: the mean of
    each ``fy x fx`` block (partial blocks at the right and bottom edges over
    the pixels they hold), as ``((sum + n // 2) * m) >> 24`` with ``m`` the
    float32 quotient ``2^32 / (256 n)`` truncated to an integer."""
    h, w, c = img.shape
    oh, ow = -(-h // fy), -(-w // fx)
    padded = np.zeros((oh * fy, ow * fx, c), np.uint64)
    padded[:h, :w] = img
    sums = padded.reshape(oh, fy, ow, fx, c).sum(axis=(1, 3))
    n = np.outer(np.minimum(fy, h - fy * np.arange(oh)),
                 np.minimum(fx, w - fx * np.arange(ow))).astype(np.uint64)
    mult = (np.float32(2.0 ** 32) / (256 * n).astype(np.float32)).astype(np.uint64)
    return (((sums + (n // 2)[..., None]) * mult[..., None]) >> 24).astype(np.uint8)


def _thumbnail_size(w: int, h: int, size: tuple[int, int]) -> tuple[int, int] | None:
    """``Image.thumbnail``'s output ``(w, h)`` for a ``w x h`` image and the
    bound ``size = (w, h)``, or ``None`` when the image already fits."""
    x, y = (math.floor(v) for v in size)
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(img: np.ndarray, size: tuple[int, int], reducing_gap: float = 2.0
              ) -> np.ndarray:
    """PIL's ``Image.thumbnail(size)`` (bicubic, ``reducing_gap=2.0``) on
    ``(H, W, C)`` uint8; ``size = (w, h)`` as PIL takes it. Returns a new
    array, the input unchanged in size when it fits already."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    final = _thumbnail_size(w, h, size)
    if final is None or final == (w, h):
        return img.copy()
    ow, oh = final
    box = (0.0, 0.0, float(w), float(h))
    fx = int(w / ow / reducing_gap) or 1
    fy = int(h / oh / reducing_gap) or 1
    if fx > 1 or fy > 1:
        # the safe box of a whole-image box is the whole image
        img = _reduce(img, fx, fy)
        box = (0.0, 0.0, w / fx, h / fy)
    x0, y0, x1, y1 = (np.float32(v) for v in box)
    if ow != img.shape[1] or x0 or x1 != ow:
        img = _resample_axis(img, ow, 1, "bicubic", x0, x1)
    if oh != img.shape[0] or y0 or y1 != oh:
        img = _resample_axis(img, oh, 0, "bicubic", y0, y1)
    return img


def _expand(img: np.ndarray, left: int, top: int, right: int, bottom: int) -> np.ndarray:
    """``ImageOps.expand(img, (left, top, right, bottom), fill=0)``."""
    h, w = img.shape[:2]
    out = np.zeros((top + h + bottom, left + w + right) + img.shape[2:], img.dtype)
    ys, xs = max(top, 0), max(left, 0)
    ye, xe = min(top + h, out.shape[0]), min(left + w, out.shape[1])
    if ye > ys and xe > xs:
        out[ys:ye, xs:xe] = img[ys - top:ye - top, xs - left:xe - left]
    return out


def padding(img: np.ndarray, expected_size: int = 320) -> np.ndarray:
    """Centre-pad ``(H, W, C)`` to ``expected_size`` square with black (the
    JAX ``padding``, PIL's ``ImageOps.expand``)."""
    dw = expected_size - img.shape[1]
    dh = expected_size - img.shape[0]
    return _expand(img, dw // 2, dh // 2, dw - dw // 2, dh - dh // 2)


def resize_with_padding(img: np.ndarray, expected_size: tuple[int, int] = (256, 256)
                        ) -> np.ndarray:
    """The body crop's letterbox: :func:`thumbnail` to fit ``expected_size =
    (w, h)``, then centred black padding to it; ``(H, W, C)`` uint8 in and
    out, bit-equal to the JAX ``resize_with_padding`` (PIL)."""
    img = thumbnail(img, expected_size)
    dw = expected_size[0] - img.shape[1]
    dh = expected_size[1] - img.shape[0]
    return _expand(img, dw // 2, dh // 2, dw - dw // 2, dh - dh // 2)


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
