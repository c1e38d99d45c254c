"""The tile boxes of K1's int8 instance, on the CPU.

That instance (``csrc/warp.cu``, ``warp_perspective_tiles_kernel``) gives
each block a ``K1_TILE`` tile of a crop, ``K1_PX`` adjacent pixels a thread,
and stage the tile's box of source pixels in shared memory: the taps of the
tile's four corner pixels, widened by ``K1_BOX_SLACK`` pixels and clipped to
the image and a ring of one pixel around it, where the corners' denominators
share one sign and are finite and the box fits the budget.
``homography.warp_tile_boxes`` is that rule in PyTorch. A pixel whose four
taps are not all in its tile's box reads them from global memory, so the
numbers never depend on the box (the card holds the kernel to its plain
version on maps that take every branch, ``chip_smoke.py``'s ``K1 reduced
stress`` lines); here the rule is held to what it promises: with the default
slack, every pixel of a staged tile that reads the image has its four taps in
the box, over seeded and drawn maps (rotations up to 45 degrees, scales
0.25-4 source pixels a crop pixel, perspective terms up to 1e-3, crops partly
off the image); tiles whose denominator changes sign, and NaN maps, stage
nothing; the kernel's blocks and threads cover every crop pixel once at
ragged sizes; the rule's constants are the kernel source's.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pets_face_recognition_tpu_torch import kernels
from pets_face_recognition_tpu_torch.ops import homography
from pets_face_recognition_tpu_torch.ops.homography import (K1_BOX_SLACK, K1_PX,
                                                            K1_STAGE_PIXELS, K1_TILE,
                                                            _sample_coords,
                                                            invert_homographies,
                                                            warp_tap_sources, warp_tile_boxes)

torch.set_num_threads(1)

CROP, IMAGE = (96, 160), (120, 150)
WARP_CU = Path(kernels.__file__).resolve().parent.parent / "csrc" / "warp.cu"


def crop_map(scale, deg, shift=(0.0, 0.0), persp=(0.0, 0.0), crop=CROP, hw=IMAGE):
    """``(1, 3, 3)`` float32 H whose inverse takes the crop about its centre to
    the image's centre plus ``shift``, rotated by ``deg`` and scaled by
    ``scale`` (source pixels a crop pixel); ``persp`` is the inverse's third
    row's x and y terms."""
    th = math.radians(deg)
    hinv = np.eye(3)
    a = scale * np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    c = np.array([(crop[1] - 1) / 2, (crop[0] - 1) / 2])
    hinv[:2, :2] = a
    hinv[:2, 2] = np.array([(hw[1] - 1) / 2 + shift[0], (hw[0] - 1) / 2 + shift[1]]) - a @ c
    hinv[2, :2] = persp
    return torch.from_numpy(np.linalg.inv(hinv)).float()[None]


def staged_tile_pixels(Hs, image=IMAGE) -> tuple[int, int]:
    """Over the pixels of staged tiles that read the image (one tap in it, by
    the plain version's sample positions): (those with a tap outside their
    box, those with all four taps in it)."""
    t = warp_tile_boxes(Hs, CROP, image)
    sx, sy = _sample_coords(invert_homographies(Hs), CROP)
    x0, y0 = sx.floor(), sy.floor()
    rows = torch.arange(CROP[0]) // K1_TILE[0]
    cols = torch.arange(CROP[1]) // K1_TILE[1]
    staged = t["staged"][:, rows][:, :, cols]
    bx, by, bw, bh = t["box"][:, rows][:, :, cols].float().unbind(-1)
    reads = torch.zeros_like(staged)
    inbox = torch.ones_like(staged)
    for yy in (y0, y0 + 1):
        for xx in (x0, x0 + 1):
            reads |= (xx >= 0) & (xx < image[1]) & (yy >= 0) & (yy < image[0])
            inbox &= (xx >= bx) & (xx < bx + bw) & (yy >= by) & (yy < by + bh)
    return int((staged & reads & ~inbox).sum()), int((staged & reads & inbox).sum())


SEEDED = [(0.6, 0.0, (0.0, 0.0), (0.0, 0.0)), (1.4, 15.0, (9.0, -4.0), (2e-4, -1e-4)),
          (0.25, 45.0, (30.0, 20.0), (1e-3, 0.0)), (4.0, -45.0, (0.0, 0.0), (0.0, 1e-3)),
          (1.0, 90.0, (50.0, 0.0), (0.0, 0.0)), (1.0, 180.0, (0.0, 0.0), (-1e-3, 1e-3)),
          (2.0, 30.0, (-60.0, 40.0), (5e-4, 5e-4))]


@pytest.mark.parametrize("case", range(len(SEEDED)))
@pytest.mark.parametrize("image", (IMAGE, (97, 211)))
def test_staged_tiles_hold_the_taps_of_every_pixel_that_reads_the_image(case, image):
    scale, deg, shift, persp = SEEDED[case]
    Hs = crop_map(scale, deg, shift, persp, hw=image)
    outside, inside = staged_tile_pixels(Hs, image)
    assert outside == 0
    counts = warp_tap_sources(Hs, CROP, image)
    assert counts["box_miss_taps"] == 0
    if scale <= 1.4:
        assert counts["staged_tiles"] > 0 and inside > 0


@settings(max_examples=30, deadline=None, derandomize=True)
@given(scale=st.floats(0.25, 4.0), deg=st.floats(-45.0, 45.0),
       sx=st.floats(-120.0, 120.0), sy=st.floats(-100.0, 100.0),
       px=st.floats(-1e-3, 1e-3), py=st.floats(-1e-3, 1e-3))
def test_drawn_maps_hold_the_taps_of_every_pixel_that_reads_the_image(scale, deg, sx, sy, px,
                                                                       py):
    outside, _ = staged_tile_pixels(crop_map(scale, deg, (sx, sy), (px, py)))
    assert outside == 0


def test_a_sign_change_and_nan_maps_stage_nothing():
    # the inverse's denominator 1 - x / 50.5 changes sign between crop columns 50 and 51
    Hs = torch.cat([crop_map(1.0, 0.0, persp=(-1.0 / 50.5, 0.0)),
                    torch.full((1, 3, 3), math.nan)])
    t = warp_tile_boxes(Hs, CROP, IMAGE)
    straddles = torch.zeros(t["safe"].shape[1:], dtype=torch.bool)
    straddles[:, 50 // K1_TILE[1]] = True       # the tiles over columns 32-63
    assert not t["safe"][0][straddles].any() and not t["staged"][0][straddles].any()
    assert t["safe"][0][~straddles].all()
    assert not t["safe"][1].any() and not t["staged"][1].any()
    assert not t["box"][1].any()
    counts = warp_tap_sources(Hs, CROP, IMAGE)
    assert counts["unsafe_tiles"] == int(straddles.sum()) + straddles.numel()


@pytest.mark.parametrize("crop", [(223, 97), (1, 1), (16, 32), (17, 33), (224, 224), (5, 200)])
def test_blocks_and_threads_cover_every_crop_pixel_once(crop):
    th, tw = K1_TILE
    tiles_y, tiles_x = -(-crop[0] // th), -(-crop[1] // tw)
    t = warp_tile_boxes(crop_map(1.0, 0.0, crop=crop), crop, IMAGE)
    assert t["staged"].shape == (1, tiles_y, tiles_x)
    hits = np.zeros(crop, np.int64)
    lanes_x = tw // K1_PX
    for tile in range(tiles_y * tiles_x):
        ty0, tx0 = tile // tiles_x * th, tile % tiles_x * tw
        for thread in range(lanes_x * th):
            oy, ox = ty0 + thread // lanes_x, tx0 + thread % lanes_x * K1_PX
            if oy >= crop[0] or ox >= crop[1]:
                continue
            for k in range(min(K1_PX, crop[1] - ox)):
                hits[oy, ox + k] += 1
    assert (hits == 1).all()


def test_boxes_are_aligned_padded_and_within_the_budget():
    Hs = torch.cat([crop_map(s, d) for s, d in ((0.6, 5.0), (1.4, 15.0), (2.0, 45.0))])
    t = warp_tile_boxes(Hs, CROP, IMAGE)
    x, y, w, h = t["box"][t["staged"]].unbind(-1)
    pitch = ((w // 4) | 1) * 4
    assert (x % 4 == 0).all() and (w % 4 == 0).all() and (w > 0).all() and (h > 0).all()
    assert (h * pitch <= K1_STAGE_PIXELS).all()
    # within the image and its one-pixel ring
    assert (y >= -1).all() and (y + h <= IMAGE[0] + 1).all()
    assert (x >= -4).all() and (x <= IMAGE[1]).all()
    assert t["staged"].any() and not t["staged"].all()    # the 45-degree x2 map is too big
    # a narrower box than the taps need: some pixels of staged tiles miss it
    counts = warp_tap_sources(Hs, CROP, IMAGE, box_slack=-3)
    assert counts["box_miss_taps"] > 0 and counts["staged_taps"] > 0


def test_k1_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """For non-CPU tensors the wrapper raises on what the kernel does not take
    (here past the device and dtype checks, with meta tensors)."""
    monkeypatch.setattr(kernels, "check_cuda_f32", lambda *a: None)
    meta = dict(device="meta")
    for images, Hs in (((1, 8, 8, 5), (1, 3, 3)), ((2, 8, 8, 3), (1, 3, 3)),
                       ((2, 8, 8, 3), (2, 2, 3))):
        with pytest.raises(ValueError, match="C<=4"):
            homography.warp_perspective_batch_cuda(torch.empty(images, **meta),
                                                   torch.empty(Hs, **meta), (4, 4),
                                                   torch.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype"):
        homography.warp_perspective_batch_cuda(torch.empty(1, 8, 8, 3, **meta),
                                               torch.empty(1, 3, 3, **meta), (4, 4),
                                               torch.float16)


KERNEL_CONSTANTS = {"kTileH": K1_TILE[0], "kTileW": K1_TILE[1], "kPx": K1_PX,
                    "kStagePixels": K1_STAGE_PIXELS, "kBoxSlack": K1_BOX_SLACK}


@pytest.mark.parametrize("name", sorted(KERNEL_CONSTANTS))
def test_tile_constants_are_the_kernel_sources(name):
    """The rule's tile, pixels a thread, budget and slack are the values that
    csrc/warp.cu compiles, so the rule cannot drift from the kernel."""
    found = re.findall(rf"^constexpr int {name} = (\d+);", WARP_CU.read_text(), re.M)
    assert found == [str(KERNEL_CONSTANTS[name])]
