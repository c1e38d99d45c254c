"""PNG read and write in numpy over the standard library's ``zlib`` (the
petfinder extras and the transform's ``.png`` outputs), in place of PIL.

:func:`read_png` takes 8-bit grey, grey + alpha, RGB, RGBA and palette images
without interlacing and returns them as PIL's ``convert("RGB")`` does: grey
replicated, alpha dropped, palette entries looked up; :func:`read_png_samples`
returns the stored samples as ``np.array(PIL.Image.open(path))`` gives them
(``(H, W)`` for grey, the palette *indices* of a palette image, ``(H, W, n)``
otherwise), as a trimap is read. The five row filters are
undone a row at a time where only None, Sub and Up occur, else along the
anti-diagonals of the image, every byte of one anti-diagonal at once (each
depends on its left, upper and upper-left neighbours only).
:func:`write_png` writes 8-bit RGB, or 8-bit grey from a 2-D array, with the
``Up`` filter.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples a pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[i:i + 8])
        yield kind, data[i + 8:i + 8 + length]
        i += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before IEND")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` (``height`` rows of a filter byte and
    ``stride`` bytes) into ``(height, stride)`` uint8."""
    rows = raw.reshape(height, stride + 1)
    kind = rows[:, 0].astype(np.int16)
    if (kind > 4).any():
        raise ValueError("unknown PNG filter type")
    if (kind <= 2).all():          # None, Sub, Up: a row at a time
        out = np.zeros((height + 1, stride), np.uint8)
        for r in range(height):
            x = rows[r, 1:]
            if kind[r] == 1:
                x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif kind[r] == 2:
                x = x + out[r]
            out[r + 1] = x
        return out[1:]
    x = rows[:, 1:].astype(np.int16)
    # Average or Paeth: a pixel-wise wavefront: byte (r, c) of pixel column p = c // bpp needs
    # (r, p - 1), (r - 1, p) and (r - 1, p - 1); pixels with r + p = d go together
    width = stride // bpp
    out = np.zeros((height + 1, (width + 1) * bpp), np.int16)   # a zero row and column
    r_all = np.arange(height)
    chan = np.arange(bpp)
    for d in range(height + width - 1):
        r = r_all[max(0, d - width + 1):min(height, d + 1)]
        p = d - r
        cols = (p[:, None] + 1) * bpp + chan        # in out's padded columns
        rr = (r + 1)[:, None]
        a = out[rr, cols - bpp]
        b = out[rr - 1, cols]
        c = out[rr - 1, cols - bpp]
        k = kind[r][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[rr, cols] = (x[r[:, None], p[:, None] * bpp + chan] + pred) & 0xFF
    return out[1:, bpp:].astype(np.uint8)


def _samples(path: str | Path) -> tuple[np.ndarray, int, np.ndarray | None]:
    """The image's samples ``(H, W, n)`` uint8, its colour type and palette."""
    data = Path(path).read_bytes()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {colour}, "
                         f"interlace {interlace}")
    n = CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * n + 1):
        raise ValueError("PNG data has the wrong length")
    return _unfilter(raw, height, width * n, n).reshape(height, width, n), colour, palette


def read_png(path: str | Path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as ``(H, W, 3)`` uint8 RGB."""
    img, colour, palette = _samples(path)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[img[..., 0]]
    if img.shape[2] < 3:           # grey, grey + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_png_samples(path: str | Path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG's stored samples, uint8: ``(H, W)`` for
    grey and for palette images (their indices, not looked up), ``(H, W, n)``
    for grey + alpha, RGB and RGBA."""
    img, _, _ = _samples(path)
    return img[..., 0] if img.shape[2] == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """``(H, W, 3)`` uint8 RGB, or ``(H, W)`` uint8 grey, as PNG bytes (8-bit,
    ``Up`` filter)."""
    img = np.ascontiguousarray(img, np.uint8)
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes (H, W, 3) or (H, W) uint8, not {img.shape}")
    h, w = img.shape[:2]
    n = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, w * n)
    up = np.empty((h, w * n + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = rows[0]
    up[1:, 1:] = rows[1:] - rows[:-1]          # mod 256
    colour = 0 if n == 1 else 2
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))
