"""Mask pasting: a detection's ``S x S`` box-frame mask -> the whole photo
(counterpart of the JAX ``ops/masks.py``): :func:`paste_mask` is its
``paste_mask_np`` (torchvision's ``paste_masks_in_image`` for one mask, on
the host's integer box), :func:`paste_masks` its device ``paste_masks`` (the
eval step's, batched).

:func:`paste_box` is the integer box, computed on the host from the float box
with the JAX expression: pad the mask by 1, scale the box about its centre by
``(S + 2) / S`` in the box's own float type (float64 where ``Preproc4`` passes
it; under numpy 2 a float32 box keeps float32 arithmetic), and truncate to
int64. :func:`paste_mask` resizes the padded mask to that box on the mask's
device with torch's ``align_corners=False`` bilinear taps (source positions in
float32, clamped at 0 and at the last row; the weights, as numpy forms them,
in float64), and pastes it, clipped to the photo, into a float32 ``(H, W)``
of zeros. Only the visible part of the box is resized, so a photo of 12 MP
costs one ``(H, W)`` float32 plane on the device and the box's four integers
on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def paste_box(box, size: int, padding: int = 1) -> np.ndarray:
    """The pasted mask's integer box ``(x1, y1, x2, y2)`` (inclusive of
    ``x2``, ``y2``) for a mask of ``size x size`` in the float ``box``."""
    box = np.asarray(box)
    scale = (size + 2.0 * padding) / size
    cx, cy = (box[2] + box[0]) * 0.5, (box[3] + box[1]) * 0.5
    w2, h2 = (box[2] - box[0]) * 0.5 * scale, (box[3] - box[1]) * 0.5 * scale
    return np.array([cx - w2, cy - h2, cx + w2, cy + h2], np.float64).astype(np.int64)


def _interp_taps(out_size: int, in_size: int):
    """One axis of ``F.interpolate(mode="bilinear", align_corners=False)``:
    ``(tap0, tap1, weight of tap1)``, the weight float64 as numpy forms it
    from a float32 source position."""
    scale = in_size / out_size
    src = np.maximum(scale * (np.arange(out_size, dtype=np.float32) + 0.5) - 0.5, 0.0)
    i0 = np.minimum(src.astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, src - i0


def paste_mask(mask, box, im_h: int, im_w: int, padding: int = 1,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Paste one ``(S, S)`` mask (a tensor or an array) into a float32
    ``(im_h, im_w)`` tensor of zeros on ``device`` (default: the mask's),
    through the box :func:`paste_box` gives for ``box``."""
    mask = torch.as_tensor(mask, device=device).float()
    dev = mask.device
    S = mask.shape[0]
    b = paste_box(box, S, padding)
    out = torch.zeros((im_h, im_w), dtype=torch.float32, device=dev)
    x_0, x_1 = max(int(b[0]), 0), min(int(b[2]) + 1, im_w)
    y_0, y_1 = max(int(b[1]), 0), min(int(b[3]) + 1, im_h)
    if x_1 <= x_0 or y_1 <= y_0:
        return out
    w = max(int(b[2] - b[0] + 1), 1)
    h = max(int(b[3] - b[1] + 1), 1)
    Sp = S + 2 * padding
    m = torch.nn.functional.pad(mask, (padding,) * 4)
    # the taps of the visible rows and columns of the (h, w) resize only
    xs = slice(x_0 - int(b[0]), x_1 - int(b[0]))
    ys = slice(y_0 - int(b[1]), y_1 - int(b[1]))
    x0, x1, lx = (torch.from_numpy(np.ascontiguousarray(a[xs])).to(dev)
                  for a in _interp_taps(w, Sp))
    y0, y1, ly = (torch.from_numpy(np.ascontiguousarray(a[ys])).to(dev)
                  for a in _interp_taps(h, Sp))
    rows = m[y0] * (1.0 - ly)[:, None] + m[y1] * ly[:, None]          # float64
    out[y_0:y_1, x_0:x_1] = rows[:, x0] * (1.0 - lx)[None, :] + rows[:, x1] * lx[None, :]
    return out


def _axis_taps(coord: torch.Tensor, size: int):
    """Bilinear taps of sample positions ``coord`` on an axis of ``size``:
    both taps clipped into it, the fraction, and whether each tap was in."""
    c0 = torch.floor(coord)
    frac = coord - c0
    c0 = c0.long()
    c1 = c0 + 1
    return (c0.clamp(0, size - 1), c1.clamp(0, size - 1), frac,
            (c0 >= 0) & (c0 < size), (c1 >= 0) & (c1 < size))


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor,
                image_size: tuple[int, int]) -> torch.Tensor:
    """``masks (..., S, S)`` probabilities in their float ``boxes (..., 4)``
    -> ``(..., H, W)`` float32 on their device (the JAX ``paste_masks``,
    vmapped there over the batch): pixel ``p`` samples the mask at ``(p + 0.5
    - x1) / max(x2 - x1, 1e-6) * S - 0.5`` by a separable bilinear whose taps
    off the mask count 0, and is 0 outside ``[floor(x1), ceil(x2)] x
    [floor(y1), ceil(y2)]``."""
    lead = masks.shape[:-2]
    S = masks.shape[-1]
    H, W = image_size
    m = masks.reshape(-1, S, S).float()
    N = m.shape[0]
    x1, y1, x2, y2 = boxes.reshape(-1, 4).float().unbind(-1)
    bw = (x2 - x1).clamp(min=1e-6)
    bh = (y2 - y1).clamp(min=1e-6)
    xs = torch.arange(W, dtype=torch.float32, device=m.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=m.device)[None, :]
    x0, x1i, fx, inx0, inx1 = _axis_taps((xs + 0.5 - x1[:, None]) / bw[:, None] * S - 0.5, S)
    y0, y1i, fy, iny0, iny1 = _axis_taps((ys + 0.5 - y1[:, None]) / bh[:, None] * S - 0.5, S)
    row0 = torch.gather(m, 1, y0[:, :, None].expand(N, H, S)) * iny0[:, :, None]
    row1 = torch.gather(m, 1, y1i[:, :, None].expand(N, H, S)) * iny1[:, :, None]
    rows = row0 * (1 - fy)[:, :, None] + row1 * fy[:, :, None]              # (N, H, S)
    c0 = torch.gather(rows, 2, x0[:, None, :].expand(N, H, W)) * inx0[:, None, :]
    c1 = torch.gather(rows, 2, x1i[:, None, :].expand(N, H, W)) * inx1[:, None, :]
    out = c0 * (1 - fx)[:, None, :] + c1 * fx[:, None, :]
    inside = ((xs[:, None, :] >= torch.floor(x1)[:, None, None])
              & (xs[:, None, :] <= torch.ceil(x2)[:, None, None])
              & (ys[:, :, None] >= torch.floor(y1)[:, None, None])
              & (ys[:, :, None] <= torch.ceil(y2)[:, None, None]))
    return torch.where(inside, out, torch.zeros_like(out)).reshape(*lead, H, W)
