#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per kernel):

0. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; exits 1 without a CUDA device (it never falls back to the CPU);
1. build: the one ``nvcc`` call over ``pets_face_recognition_tpu_torch/csrc``;
2. kernel: K1 warp (B = 8 and 32), K2 NMS and K3 RoIAlign at the serving
   path's shapes (B = 8); then K2 at the training budget (80 groups of 2000
   boxes), the two K5 entry points over the same kernels, and K3 and K4
   (RoIAlign forward and backward) at the training step's shapes (16 images
   of 640 x 640, 8192 box RoIs at 7 x 7 and 2048 keypoint RoIs at 14 x 14).
   Each is held against its plain PyTorch version on the card and timed with
   CUDA events (median after warm-up) beside the plain version, the one
   library call that computes the same function where there is one, and its
   bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), and (but K4's
   pre-pass) with its kernels' device time per call from ``torch.profiler``
   (for K2 and K5 the sum of K2's two kernels), K1 also beside the
   library's whole route from the maps (inverse, grid, ``grid_sample``,
   permutes), and against ``grid_sample`` alone in paired rounds (the two
   timed one after the other, in alternating order). K4 must give the same
   bits in two launches on the same inputs, and its pre-pass the same
   integers as its plain twin; last, K2 and K3 at edge shapes (ragged and
   long groups, narrow channels, a non-square output, 2 levels, sampling
   ratios 1 and 3) against their plain versions;
3. e2e: ``build_serving_models`` at full ResNet-50 width with seeded random
   weights, ``EmbeddingService.embed_batch`` on seeded uint8 320x320 images at
   B = 8 with the launch counts read around it, checks against the same models
   on the CPU on a B = 2 input, then crops/s at B = 32;
4. train: keypoint R-CNN ResNet-50-FPN training steps at full width with the
   training defaults (RPN 2000/2000, 512 box samples at 0.25, keypoint head on
   128 positives an image) and the keypoint config's SGD (lr 5e-3, momentum
   0.9, weight decay 1e-4), on a seeded synthetic batch of 16 images of
   640 x 640 with 4 boxes each: 1 warm-up and 3 timed steps, with the launch
   counts read around them (K2, K3 and K4 must have run), the loss dict of
   every step (finite), step ms, images/s and peak memory; then two steps
   from one saved state on the same batch and noise, with the count of
   parameter gradients that differ bitwise (reported, not held), by default,
   with deterministic cuDNN and with ``torch.use_deterministic_algorithms``
   (every warning's text kept), and the step time of deterministic
   algorithms against the default in 3 alternating rounds;
5. train_vs_cpu: one step of the same model at 256 x 256, B = 2, reduced
   sampler budgets, from the same weights and sampler noise on the card and on
   the CPU: losses within 1e-3 relative, every gradient within 5e-3 relative
   in norm.

Then a ``kernels`` JSON line (K1-K5 and K4's pre-pass; ``max_abs_err`` is each
row's largest absolute difference from its plain version on the card, 0 or 1
for a keep mask, an integer for the pre-pass), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``, printed only if every phase passed. The
script leaves torch's TF32 defaults as they are: the entry points
(``embed_batch``, ``train_step``) turn TF32 off inside themselves, a forward
pre-hook records the switches their models see (the run fails if TF32 was on
there, or if the switches were not restored after), and models called
directly run under ``float32_matmuls``. Every number is float32. A hang
becomes a traceback and exit 1 through ``faulthandler``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
B_KERNELS = 8                      # batch of the kernel phase
B_TIMED = 32                       # batch of the end-to-end timing
IMAGE = 320
CROP = 224
B_TRAIN = 16                       # keypoint config: train_batch_size
IMAGE_TRAIN = 640                  # keypoint config: image_size
MAX_BOXES = 4                      # keypoint config: max_boxes
K2_KERNELS = "nms_keep_sorted_batch_"  # K2's two kernels: the IoU words, the sweep


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def grid_sample_grid(Hs):
    """``grid_sample``'s ``(B, 224, 224, 2)`` grid (align_corners=True) from the
    maps ``Hs``: each output pixel's source position ``H^-1 @ (x, y, 1)``."""
    import torch

    hinv = torch.linalg.inv(Hs)
    gy, gx = torch.meshgrid(torch.arange(CROP, device=Hs.device, dtype=torch.float32),
                            torch.arange(CROP, device=Hs.device, dtype=torch.float32),
                            indexing="ij")
    h = hinv[:, :, :, None, None]
    den = h[:, 2, 0] * gx + h[:, 2, 1] * gy + h[:, 2, 2]
    sx = (h[:, 0, 0] * gx + h[:, 0, 1] * gy + h[:, 0, 2]) / den
    sy = (h[:, 1, 0] * gx + h[:, 1, 1] * gy + h[:, 1, 2]) / den
    return torch.stack([2 * sx / (IMAGE - 1) - 1, 2 * sy / (IMAGE - 1) - 1], -1)


def grid_sample_route(images, Hs):
    """The library's whole route for K1's function: NHWC images and maps in,
    NHWC crops out, through ``grid_sample``."""
    import torch

    out = torch.nn.functional.grid_sample(images.permute(0, 3, 1, 2), grid_sample_grid(Hs),
                                          padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).contiguous()


def paired_ms(fn_a, fn_b, rounds: int = 7) -> list[tuple[float, float]]:
    """``(cuda_ms(fn_a), cuda_ms(fn_b))`` for each of ``rounds`` rounds, ``fn_a``
    timed first in even rounds and second in odd ones."""
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms

    out = []
    for r in range(rounds):
        if r % 2 == 0:
            a = cuda_ms(fn_a)
            b = cuda_ms(fn_b)
        else:
            b = cuda_ms(fn_b)
            a = cuda_ms(fn_a)
        out.append((a, b))
    return out


def warp_read_bytes(images, Hs) -> int:
    """Bytes that K1 must read from the source on these inputs: each image's
    distinct pixels under the crop's bilinear taps that lie inside the image
    and carry a nonzero weight (the plain version's sample positions), C
    float32 values each."""
    import torch
    from pets_face_recognition_tpu_torch.ops.homography import (_sample_coords,
                                                                invert_homographies)

    B, H, W, C = images.shape
    sx, sy = _sample_coords(invert_homographies(Hs), (CROP, CROP))
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = sx - x0, sy - y0
    b = torch.arange(B, device=images.device)[:, None, None]
    keys = []
    for yy, wy in ((y0, 1 - fy), (y0 + 1, fy)):
        for xx, wx in ((x0, 1 - fx), (x0 + 1, fx)):
            ok = (wy != 0) & (wx != 0) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            flat = (b * H + yy.clamp(0, H - 1).long()) * W + xx.clamp(0, W - 1).long()
            keys.append(flat[ok])
    return int(torch.unique(torch.cat(keys)).numel()) * C * 4


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn()`` in us, back to back after warm-up, without
    waiting for the device inside the loop."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def similarity_landmarks(g, B: int, base, image: int):
    """Well-formed landmarks: seeded similarity transforms of the base points."""
    import torch

    scale = 0.6 + 0.8 * torch.rand(B, generator=g)
    theta = (torch.rand(B, generator=g) - 0.5) * math.radians(30.0)
    center = image / 2 + (torch.rand(B, 2, generator=g) - 0.5) * 80.0
    rot = torch.stack([torch.stack([theta.cos(), -theta.sin()], -1),
                       torch.stack([theta.sin(), theta.cos()], -1)], -2)
    rel = base.cpu() - base.cpu().mean(0)
    return (scale[:, None, None] * rel[None] @ rot.transpose(1, 2)) + center[:, None, :]


def kernel_phase(dev) -> dict[str, dict]:
    """Phase 2, serving: K1-K3 against their plain versions at serving shapes."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms, device_us, random_rois
    from pets_face_recognition_tpu_torch.ops import homography, nms, roi_align
    from pets_face_recognition_tpu_torch.profile_serving import nms_work

    g = torch.Generator().manual_seed(0)
    rows = {}

    # K1: (B, 320, 320, 3) -> (B, 224, 224, 3) at the kernel phase's B = 8 and
    # the timed serving batch's B = 32; the row keeps B = 8
    for B in (B_KERNELS, B_TIMED):
        gb = g if B == B_KERNELS else torch.Generator().manual_seed(4)
        images = torch.rand(B, IMAGE, IMAGE, 3, generator=gb).to(dev)
        base = torch.tensor([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]])
        lms = similarity_landmarks(gb, B, base, IMAGE).to(dev)
        Hs = homography.alignment_homographies(lms, base.to(dev))
        got = homography.warp_perspective_batch_cuda(images, Hs, (CROP, CROP))
        want = homography.warp_perspective_batch(images, Hs, (CROP, CROP))
        torch.cuda.synchronize()
        err, tol = max_err(got, want), 1e-4
        k1 = lambda: homography.warp_perspective_batch_cuda(  # noqa: E731
            images, Hs, (CROP, CROP))
        kernel_us = device_us(k1, "warp_perspective_kernel")
        plain = cuda_ms(lambda: homography.warp_perspective_batch(images, Hs, (CROP, CROP)))
        # the library: grid_sample (zero padding) on a grid from H^-1, alone on a
        # grid built beforehand, and as the whole route from Hs (inverse, grid,
        # grid_sample, layout permutes), which is what the K1 wrapper replaces
        route = lambda: grid_sample_route(images, Hs)  # noqa: E731
        lib_out = route()
        lib_err = max_err(lib_out, want)
        grid = grid_sample_grid(Hs)
        nchw = images.permute(0, 3, 1, 2)
        lib_call = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw, grid, padding_mode="zeros", align_corners=True)
        # the wrapper against grid_sample alone, in paired rounds; the medians
        # are the row's ms and library_ms
        pairs = paired_ms(k1, lib_call)
        ms = statistics.median(a for a, _ in pairs)
        lib_ms = statistics.median(b for _, b in pairs)
        lib_us = device_us(lib_call, "", strict=False)
        # the wrapper's and the library call's host time: with one small
        # kernel each, the single-call times above are mostly host work
        wrap_host = host_us(k1)
        lib_host = host_us(lib_call)
        route_ms = cuda_ms(route)
        # bytes: the source pixels the taps read, the maps, the crops
        src_bytes = warp_read_bytes(images, Hs)
        n_bytes = src_bytes + Hs.numel() * 4 + got.numel() * 4
        n_flops = B * CROP * CROP * (24 + 7 * 3)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name="K1 warp_perspective_batch", shape=list(images.shape),
             max_abs_err=err, atol=tol, ms=ms, kernel_device_us=kernel_us, plain_ms=plain,
             wrapper_host_us=wrap_host, library_ms=lib_ms, library_device_us=lib_us,
             library_host_us=lib_host,
             library="grid_sample(zeros, align_corners=True) alone, "
             "on a grid built beforehand", paired_ms=pairs,
             rounds_k1_not_slower=sum(a <= b for a, b in pairs), library_route_ms=route_ms,
             library_route="inv + grid from H^-1 + grid_sample + NHWC permutes, from Hs",
             library_max_abs_err=lib_err, bound_ms=b, bound_by=by,
             source_bytes_read=src_bytes, source_bytes_total=images.numel() * 4)
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
        if B == B_KERNELS:
            rows["warp_perspective_batch"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                  bound_ms=b, bound_by=by, library_ms=lib_ms)

    # K2: G = 5 levels x 8 images, K = 128 score-sorted boxes, thr 0.7
    G, K = 5 * B_KERNELS, 128
    xy = torch.rand(G, K, 2, generator=g) * 280
    wh = 8 + torch.rand(G, K, 2, generator=g) * 120
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    valid = (torch.rand(G, K, generator=g) > 0.1).to(dev)
    got = nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7)
    want = nms.nms_keep_sorted_batch(boxes, valid, 0.7)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    ms = cuda_ms(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7))
    k2_us = device_us(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7), K2_KERNELS)
    # at this size the call is mostly host work
    k2_host = host_us(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7))
    plain = cuda_ms(lambda: nms.nms_keep_sorted_batch(boxes, valid, 0.7), iters=5)
    # IoUs this data needs: each live pivot against the live boxes after it
    n_iou = int(nms_work(boxes, valid, want, 0.7)["ious"].sum())
    n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
    b, by = bound_ms(n_bytes, n_iou * 13)
    emit("kernel", name="K2 nms_keep_sorted_batch", shape=[G, K, 4], mismatches=n_diff,
         kept=int(got.sum()), ms=ms, kernel_device_us=k2_us, wrapper_host_us=k2_host,
         plain_ms=plain, library_ms=None,
         library="none (no torchvision)", bound_ms=b, bound_by=by, ious=n_iou,
         sequential_steps=K)
    if n_diff:
        raise AssertionError(f"K2 keep mask differs from the plain version in {n_diff}")
    rows["nms_keep_sorted_batch"] = dict(max_abs_err=max_err(got, want), ms=ms, plain_ms=plain,
                                         bound_ms=b, bound_by=by, library_ms=None)

    # K3: p2..p5 of a 320 image, C = 256; box RoIs 16/image at 7x7, keypoint
    # RoIs 1/image at 14x14. Boxes include ones overhanging the image and wide
    # ones (5:1) that the TPU kernel's fixed windows would clamp.
    C = 256
    levels = [torch.randn(B_KERNELS, s, s, C, generator=g).to(dev) for s in (80, 40, 20, 10)]
    strides = (4, 8, 16, 32)

    k3_ms = k3_plain = k3_bound_b = k3_flops = 0.0
    k3_err = 0.0
    for n_per, out in ((16, 7), (1, 14)):
        rois = random_rois(g, B_KERNELS * n_per, IMAGE, 4.5).to(dev)
        bidx = torch.arange(B_KERNELS, device=dev).repeat_interleave(n_per).to(torch.int32)
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args)
        want = roi_align.multilevel_roi_align(*args)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), 1e-4
        k3_err = max(k3_err, err)
        ms = cuda_ms(lambda: roi_align.multilevel_roi_align_cuda(*args))
        us = device_us(lambda: roi_align.multilevel_roi_align_cuda(*args),
                       "multilevel_roi_align_kernel")
        plain = cuda_ms(lambda: roi_align.multilevel_roi_align(*args))
        cells = touched_cells(levels, rois, bidx, (out, out), strides)
        n_bytes = cells * C * 4 + rois.numel() * 4 + bidx.numel() * 4 + got.numel() * 4
        n_flops = got.numel() * (8 * 4 + 1)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name=f"K3 multilevel_roi_align {out}x{out}", rois=rois.shape[0],
             max_abs_err=err, atol=tol, ms=ms, kernel_device_us=us, plain_ms=plain,
             library_ms=None, library="none (no torchvision)", bound_ms=b, bound_by=by,
             touched_cells=cells)
        if not err <= tol:
            raise AssertionError(f"K3 {out}x{out} disagrees: {err} > {tol}")
        k3_ms += ms
        k3_plain += plain
        k3_bound_b += n_bytes
        k3_flops += n_flops
    b, by = bound_ms(k3_bound_b, k3_flops)
    rows["multilevel_roi_align"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
                                        bound_ms=b, bound_by=by, library_ms=None)
    return rows


def train_kernel_phase(dev) -> dict[str, dict]:
    """Phase 2, training: K2 at the training budget, K5, and K3/K4 at the
    training step's shapes, each against its plain version."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms, device_us, random_rois
    from pets_face_recognition_tpu_torch.ops import nms, roi_align
    from pets_face_recognition_tpu_torch.profile_serving import nms_work

    g = torch.Generator().manual_seed(3)
    rows = {}

    # K2 / K5: 16 images x 5 levels, 2000 score-sorted boxes each, thr 0.7
    G, K, thr = B_TRAIN * 5, 2000, 0.7
    boxes = random_rois(g, G * K, IMAGE_TRAIN, 4.0).reshape(G, K, 4).contiguous().to(dev)
    valid = (torch.rand(G, K, generator=g) > 0.1).to(dev)
    want = nms.nms_keep_sorted_batch(boxes, valid, thr)
    n_iou = int(nms_work(boxes, valid, want, thr)["ious"].sum())
    n_bytes = boxes.numel() * 4 + valid.numel() * 2
    entries = (
        ("K2 nms_keep_sorted_batch", "nms_keep_sorted_batch",
         lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, thr),
         lambda: nms.nms_keep_sorted_batch(boxes, valid, thr), want, n_iou, n_bytes, G),
        ("K5 nms_keep_sorted_grid", "nms_keep_sorted_grid",
         lambda: nms.nms_keep_sorted_grid(boxes, valid, thr),
         lambda: nms.nms_keep_sorted_batch(boxes, valid, thr), want, n_iou, n_bytes, G),
        ("K5 nms_keep_sorted", "nms_keep_sorted",
         lambda: nms.nms_keep_sorted(boxes[0], valid[0], thr),
         lambda: nms.nms_keep_sorted_batch(boxes[:1], valid[:1], thr)[0], want[0],
         int(nms_work(boxes[:1], valid[:1], want[:1], thr)["ious"].sum()), n_bytes // G, 1),
    )
    for label, name, fn, plain_fn, ref, ious, nb, groups in entries:
        got = fn()
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum())
        ms = cuda_ms(fn, warmup=2, iters=10)
        us = device_us(fn, K2_KERNELS)
        plain = cuda_ms(plain_fn, warmup=1, iters=3)
        b, by = bound_ms(nb, ious * 13)
        emit("kernel", name=label, groups=groups, boxes_per_group=K, mismatches=n_diff,
             kept=int(got.sum()), ms=ms, kernel_device_us=us, plain_ms=plain, library_ms=None,
             library="none (no torchvision)", bound_ms=b, bound_by=by, ious=ious,
             sequential_steps=K)
        if n_diff:
            raise AssertionError(f"{label} keep mask differs from the plain version in {n_diff}")
        rows[name] = dict(max_abs_err=max_err(got, ref), ms=ms, plain_ms=plain, bound_ms=b,
                          bound_by=by, library_ms=None)
    del boxes, valid, want

    # K3 / K4: p2..p5 of 16 images of 640 x 640, C = 256; 512 box RoIs an image
    # at 7 x 7 and 128 keypoint RoIs an image at 14 x 14, over every level,
    # with RoIs off the image's edges and 5:1 ones
    C, strides = 256, (4, 8, 16, 32)
    levels = [torch.randn(B_TRAIN, IMAGE_TRAIN // st, IMAGE_TRAIN // st, C, generator=g).to(dev)
              for st in strides]
    shapes = [tuple(f.shape) for f in levels]
    level_bytes = sum(f.numel() for f in levels) * 4
    fwd = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    bwd = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    pre = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    for n_per, out in ((512, 7), (128, 14)):
        n = B_TRAIN * n_per
        rois = random_rois(g, n, IMAGE_TRAIN, 5.0).to(dev)
        bidx = torch.arange(B_TRAIN, device=dev).repeat_interleave(n_per).to(torch.int32)
        per_level = torch.bincount(roi_align.roi_levels(rois, 2, 5).long(), minlength=4)
        if not bool((per_level > 0).all()):
            raise AssertionError(f"RoIs miss a level: {per_level.tolist()}")
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args)
        want = roi_align.multilevel_roi_align(*args)
        torch.cuda.synchronize()
        err_f = max_err(got, want)
        del want
        grad = torch.randn(n, out, out, C, generator=g).to(dev)
        bargs = (grad, shapes, rois, bidx, (out, out), strides)
        # K4's pre-pass kernel against its plain twin: the same integers
        lvl = roi_align.roi_levels(rois, 2, 5)
        pargs = (shapes, rois, bidx, lvl, (out, out), strides)
        key, fp = roi_align.roi_footprints_cuda(*pargs)
        b64 = bidx.long()
        want_key = torch.where((b64 >= 0) & (b64 < B_TRAIN), lvl.long() * B_TRAIN + b64,
                               torch.full_like(b64, 4 * B_TRAIN))
        plain_pre = lambda: (want_key.to(torch.int32),  # noqa: E731
                             roi_align.roi_footprints(shapes, rois, lvl, (out, out), strides))
        want_fp = plain_pre()[1]
        pre_diff = int((key != want_key).sum()) + int((fp != want_fp).sum())
        pre_err = max(max_err(key, want_key), max_err(fp, want_fp))
        tp = dict(ms=cuda_ms(lambda: roi_align.roi_footprints_cuda(*pargs)),
                  plain=cuda_ms(plain_pre))
        p_bytes = n * (16 + 4 + 4 + 4 + 16)
        b, by = bound_ms(p_bytes, n * 2 * 12)
        emit("kernel", name=f"K4 pre-pass roi_footprints {out}x{out}", rois=n,
             mismatches=pre_diff, max_abs_err=pre_err, ms=tp["ms"], plain_ms=tp["plain"],
             library_ms=None,
             library="none", bound_ms=b, bound_by=by)
        if pre_diff:
            raise AssertionError(f"K4 pre-pass {out}x{out} differs from its plain twin in "
                                 f"{pre_diff} integers")
        pre["ms"] += tp["ms"]
        pre["plain"] += tp["plain"]
        pre["bytes"] += p_bytes
        pre["flops"] += n * 2 * 12
        pre["err"] = max(pre["err"], pre_err)
        got_b = roi_align.multilevel_roi_align_backward_cuda(*bargs)
        again_b = roi_align.multilevel_roi_align_backward_cuda(*bargs)
        want_b = roi_align.multilevel_roi_align_backward(*bargs)
        torch.cuda.synchronize()
        err_b = max(max_err(a, w) for a, w in zip(got_b, want_b))
        scale_b = max(float(w.abs().max()) for w in want_b)
        # K4 owns each output element and sums in a fixed order: two launches
        # on the same inputs must agree to the bit
        bit_diff = sum(int((a != r).sum()) for a, r in zip(got_b, again_b))
        del got_b, again_b, want_b
        # float32 rounding of sums of up to a few hundred contributions, in
        # another order than the plain version's, hence 1e-4 absolute
        tol_f, tol_b = 1e-4, 1e-4
        t = dict(ms=cuda_ms(lambda: roi_align.multilevel_roi_align_cuda(*args), iters=10),
                 plain=cuda_ms(lambda: roi_align.multilevel_roi_align(*args), warmup=1, iters=3),
                 us=device_us(lambda: roi_align.multilevel_roi_align_cuda(*args),
                              "multilevel_roi_align_kernel", iters=5))
        tb = dict(ms=cuda_ms(lambda: roi_align.multilevel_roi_align_backward_cuda(*bargs),
                             iters=10),
                  plain=cuda_ms(lambda: roi_align.multilevel_roi_align_backward(*bargs),
                                warmup=1, iters=3),
                  us=device_us(lambda: roi_align.multilevel_roi_align_backward_cuda(*bargs),
                               "multilevel_roi_align_backward_kernel", iters=5))
        cells = touched_cells(levels, rois, bidx, (out, out), strides)
        out_bytes = n * out * out * C * 4
        io_bytes = rois.numel() * 4 + bidx.numel() * 4
        f_bytes, f_flops = cells * C * 4 + io_bytes + out_bytes, n * out * out * C * (8 * 4 + 1)
        b_bytes, b_flops = out_bytes + io_bytes + level_bytes, n * out * out * C * (8 * 4 + 1)
        for label, tm, nb, nf, err, tol in (
                (f"K3 multilevel_roi_align {out}x{out}", t, f_bytes, f_flops, err_f, tol_f),
                (f"K4 multilevel_roi_align_backward {out}x{out}", tb, b_bytes, b_flops, err_b,
                 tol_b)):
            b, by = bound_ms(nb, nf)
            emit("kernel", name=label, rois=n, shape=[B_TRAIN, IMAGE_TRAIN, IMAGE_TRAIN, C],
                 rois_per_level=per_level.tolist(), max_abs_err=err, atol=tol, ms=tm["ms"],
                 kernel_device_us=tm["us"], plain_ms=tm["plain"], library_ms=None,
                 library="none (no torchvision)", bound_ms=b, bound_by=by,
                 **({"grad_max_abs": scale_b, "second_launch_bits_differ": bit_diff}
                    if "K4" in label else {"touched_cells": cells}))
            if not err <= tol:
                raise AssertionError(f"{label} disagrees with its plain version: {err} > {tol}")
        if bit_diff:
            raise AssertionError(f"K4 {out}x{out}: two launches on the same inputs differ in "
                                 f"{bit_diff} elements")
        for acc, tm, nb, nf, err in ((fwd, t, f_bytes, f_flops, err_f),
                                     (bwd, tb, b_bytes, b_flops, err_b)):
            acc["ms"] += tm["ms"]
            acc["plain"] += tm["plain"]
            acc["bytes"] += nb
            acc["flops"] += nf
            acc["err"] = max(acc["err"], err)
    for name, acc in (("multilevel_roi_align", fwd), ("multilevel_roi_align_backward", bwd),
                      ("roi_footprints", pre)):
        b, by = bound_ms(acc["bytes"], acc["flops"])
        rows[name] = dict(max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain"],
                          bound_ms=b, bound_by=by, library_ms=None)
    # K5 is one row: the grid entry point at the training shapes; the
    # single-group entry point's numbers are in its own phase line
    single = rows.pop("nms_keep_sorted")
    rows["nms_keep_sorted_grid"]["max_abs_err"] = max(rows["nms_keep_sorted_grid"]["max_abs_err"],
                                                      single["max_abs_err"])
    return rows


def edge_phase(dev) -> None:
    """Phase 2, edges: K2 and K3 at shapes no path of the port gives them yet,
    each against its plain version: K2 at K = 1, 65 (a ragged last word),
    2049 (two words a lane) and 5000 (past the default 48 KB of shared
    memory), and at threshold 0 (outside the IoU test's division-free
    range); K3 with C = 12 (channel groups that do not fill a warp), a 7 x 5
    output, 2 levels and sampling ratios 1 and 3 (the kernel's generic S, a
    mean that is not a power of two)."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import random_rois
    from pets_face_recognition_tpu_torch.ops import nms, roi_align

    g = torch.Generator().manual_seed(5)
    k2 = {}
    for K, thr in ((1, 0.7), (65, 0.7), (65, 0.0), (2049, 0.5), (5000, 0.7)):
        boxes = random_rois(g, 3 * K, IMAGE_TRAIN, 4.0).reshape(3, K, 4).contiguous().to(dev)
        valid = (torch.rand(3, K, generator=g) > 0.1).to(dev)
        got = nms.nms_keep_sorted_batch_cuda(boxes, valid, thr)
        k2[f"K={K} thr={thr}"] = int((got != nms.nms_keep_sorted_batch(boxes, valid, thr)).sum())
    levels = [torch.randn(2, s, s, 12, generator=g).to(dev) for s in (40, 20)]
    rois = random_rois(g, 40, IMAGE, 3.0).to(dev)
    bidx = (torch.arange(40) % 2).to(torch.int32).to(dev)
    k3 = {}
    for S in (1, 3):
        args = (levels, rois, bidx, (7, 5), (8, 16), S, 224.0, 4, 3, 4)
        k3[S] = max_err(roi_align.multilevel_roi_align_cuda(*args),
                        roi_align.multilevel_roi_align(*args))
    torch.cuda.synchronize()
    emit("edge", k2_mismatches=k2, k3_max_abs_err=k3, k3_atol=1e-4)
    if any(k2.values()):
        raise AssertionError(f"K2 keep masks differ from the plain version: {k2}")
    if not all(e <= 1e-4 for e in k3.values()):
        raise AssertionError(f"K3 disagrees with its plain version: {k3}")


def touched_cells(levels, rois, bidx, output_size, strides, s: int = 2) -> int:
    """Distinct (image, level, y, x) cells that the bilinear taps read."""
    import torch
    from pets_face_recognition_tpu_torch.ops.roi_align import _sample_offsets, roi_levels

    oh, ow = output_size
    lvl = roi_levels(rois, 2, 5).long()
    keys = []
    for li, f in enumerate(levels):
        sel = lvl == li
        if not sel.any():
            continue
        H, W = f.shape[1], f.shape[2]
        r = rois[sel] / strides[li]
        roi_w = (r[:, 2] - r[:, 0]).clamp(min=1.0)
        roi_h = (r[:, 3] - r[:, 1]).clamp(min=1.0)
        ys = r[:, 1:2] + _sample_offsets(oh, s, f.device)[None] * (roi_h / oh)[:, None]
        xs = r[:, 0:1] + _sample_offsets(ow, s, f.device)[None] * (roi_w / ow)[:, None]
        yy, xx = ys[:, :, None].expand(-1, -1, ow * s), xs[:, None, :].expand(-1, oh * s, -1)
        ok = ~((yy <= -1) | (yy >= H) | (xx <= -1) | (xx >= W))
        y0 = yy.clamp(min=0).floor().clamp(max=H - 1).long()
        x0 = xx.clamp(min=0).floor().clamp(max=W - 1).long()
        bb = bidx[sel].long()[:, None, None].expand_as(y0)
        for dy in (0, 1):
            for dx in (0, 1):
                yi = (y0 + dy).clamp(max=H - 1)
                xi = (x0 + dx).clamp(max=W - 1)
                keys.append((((bb * 4 + li) * 4096 + yi) * 4096 + xi)[ok])
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


@contextlib.contextmanager
def tf32_watch(model):
    """Record the TF32 switches that ``model``'s forward sees (a forward
    pre-hook) while the block calls an entry point; raise if TF32 was on in
    any call, or if the caller's switches were not back afterwards."""
    from pets_face_recognition_tpu_torch.device import float32_flags, tf32_flags

    seen = []
    caller = tf32_flags()
    handle = model.register_forward_pre_hook(lambda m, a: seen.append(tf32_flags()))
    record = {"caller": caller, "inside": seen}
    try:
        yield record
    finally:
        handle.remove()
    record["after"] = tf32_flags()
    record["inside"] = seen[0] if seen else None
    if not seen or any(s != float32_flags() for s in seen):
        raise AssertionError(f"TF32 switches inside the entry point: {seen[:1]}, "
                             f"expected {float32_flags()}")
    if record["after"] != caller:
        raise AssertionError(f"TF32 switches not restored: {record['after']} != {caller}")


def e2e_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase 3: the serving path at full width, its launch counts and checks."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.ops.homography import align_crop
    from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models

    t0 = time.perf_counter()
    detector, embedder, base = build_serving_models(device=dev, seed=0)
    service = EmbeddingService(detector, embedder, base, device=dev)
    g = torch.Generator().manual_seed(1)
    imgs8 = torch.randint(0, 256, (B_KERNELS, IMAGE, IMAGE, 3), generator=g,
                          dtype=torch.uint8).to(dev)
    ok8 = torch.ones(B_KERNELS, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    with tf32_watch(detector) as flags:
        kernels_mod.reset_launch_counts()
        emb, valid = service.embed_batch(imgs8, ok8)
        torch.cuda.synchronize()
        launches = kernels_mod.launch_counts()
    if emb.shape != (B_KERNELS, 512) or valid.shape != (B_KERNELS,):
        raise AssertionError(f"bad shapes {tuple(emb.shape)} {tuple(valid.shape)}")
    if not bool(torch.isfinite(emb[valid]).all()):
        raise AssertionError("non-finite embeddings on valid rows")
    missing = [k for k in ("warp_perspective_batch", "nms_keep_sorted_batch",
                           "multilevel_roi_align") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")
    emit("e2e", batch=B_KERNELS, launches=launches, valid_rows=int(valid.sum()),
         model_build_s=build_s, tf32_flags=flags)

    # reference: the same seeded models on the CPU (plain versions), B = 2
    det_cpu, emb_cpu, base_cpu = build_serving_models(device="cpu", seed=0)
    x = imgs8[:2].float() / 255.0
    # the models called directly, not through an entry point: float32 as there
    with torch.inference_mode(), float32_matmuls():
        d_gpu = detector(x)
        d_cpu = det_cpu(x.cpu())
        feats_gpu = detector.backbone(x.permute(0, 3, 1, 2))
        feats_cpu = det_cpu.backbone(x.cpu().permute(0, 3, 1, 2))
        pyr_rel = max(max_err(feats_gpu[k].cpu(), feats_cpu[k])
                      / float(feats_cpu[k].abs().max()) for k in feats_cpu)
        score_err = max_err(d_gpu["scores"].cpu(), d_cpu["scores"])
        lms = similarity_landmarks(torch.Generator().manual_seed(2), 2, base_cpu, IMAGE)
        crops_gpu = align_crop(x, lms.to(dev), base, (CROP, CROP))
        crops_cpu = align_crop(x.cpu(), lms, base_cpu, (CROP, CROP))
        crop_err = max_err(crops_gpu.cpu(), crops_cpu)
        e_gpu, e_cpu = embedder(crops_gpu).cpu(), emb_cpu(crops_cpu)
        emb_rel = max_err(e_gpu, e_cpu) / float(e_cpu.abs().max())
        box_err = max_err(d_gpu["boxes"].cpu(), d_cpu["boxes"])
        kp_err = max_err(d_gpu["keypoints"].cpu(), d_cpu["keypoints"])
    # crops: the CPU and the card solve the 8x8 homography system with other
    # float32 LU codes; ~1e-6 relative in H moves corner samples by up to
    # ~1e-3 px on a [0, 1] noise image, hence 1e-3 (as the CPU parity test)
    checks = dict(pyramid_rel_err=pyr_rel, top_score_abs_err=score_err,
                  crop_abs_err=crop_err, embedding_rel_err=emb_rel)
    emit("e2e_reference", batch=2, **checks, tolerances=dict(
        pyramid_rel_err=1e-3, top_score_abs_err=1e-3, crop_abs_err=1e-3,
        embedding_rel_err=1e-3), top_box_abs_err_px=box_err,
        keypoint_abs_err_px=kp_err,
        note="boxes and keypoints are argmax picks and are reported, not held: "
             "a near-tie may pick another candidate")
    for name, tol in (("pyramid_rel_err", 1e-3), ("top_score_abs_err", 1e-3),
                      ("crop_abs_err", 1e-3), ("embedding_rel_err", 1e-3)):
        if not checks[name] <= tol:
            raise AssertionError(f"{name} {checks[name]} > {tol}")

    imgs = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                         dtype=torch.uint8).to(dev)
    ok = torch.ones(B_TIMED, dtype=torch.bool, device=dev)
    service.embed_batch(imgs, ok)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        emb, valid = service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if not bool(torch.isfinite(emb[valid]).all()):
        raise AssertionError("non-finite embeddings on valid rows at B=32")
    step = statistics.median(times)
    emit("e2e_timed", batch=B_TIMED, step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in times],
         crops_per_s=B_TIMED / step, valid_rows=int(valid.sum()), card=smi,
         precision="float32: TF32 off inside embed_batch, torch's defaults outside",
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


def train_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase 4: full-width training steps on one synthetic batch."""
    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController

    ctl = KeyPointsController()
    B = B_TRAIN
    while True:
        state = ctl.init_state(seed=0, device=dev)
        batch = synthetic_keypoint_batch(B, IMAGE_TRAIN, IMAGE_TRAIN, MAX_BOXES, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        try:
            steps = []
            with tf32_watch(state.model) as flags:
                for _ in range(4):
                    t = time.perf_counter()
                    metrics = ctl.train_step(state, batch)
                    torch.cuda.synchronize()
                    steps.append((time.perf_counter() - t, metrics))
            break
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
            del state
            torch.cuda.empty_cache()
            emit("train_cut", batch_from=B, batch_to=B // 2,
                 reason="torch.cuda.OutOfMemoryError at the keypoint config's batch")
            B //= 2
    launches = kernels_mod.launch_counts()
    for i, (_, m) in enumerate(steps):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite loss at step {i}: {m}")
    missing = [k for k in ("nms_keep_sorted_batch", "multilevel_roi_align", "roi_footprints",
                           "multilevel_roi_align_backward") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the training steps: {missing}")
    timed = [t for t, _ in steps[1:]]
    step = statistics.median(timed)
    emit("train", batch=B, image=IMAGE_TRAIN, max_boxes=MAX_BOXES, cut=B != B_TRAIN,
         steps=len(steps), warmup_steps=1, step_ms=step * 1e3,
         step_ms_all=[t * 1e3 for t, _ in steps], images_per_s=B / step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         losses=[m for _, m in steps], launches=launches,
         launches_per_step={k: v / len(steps) for k, v in launches.items()}, card=smi,
         precision="float32: TF32 off inside train_step, torch's defaults outside",
         tf32_flags=flags)
    repro_phase(ctl, state, batch, B)
    del state
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    deterministic cuDNN inside the block; the caller's settings back after."""
    import torch

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def repro_phase(ctl, state, batch, B: int) -> None:
    """Phase 4b: two training steps from one saved state on the same batch and
    sampler noise; reports how many parameter gradients differ bitwise (a
    reported number, not a gate: cuDNN and PyTorch may pick kernels that sum
    in a run-dependent order). Then the same with deterministic cuDNN
    algorithms only, and with ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` as well, each with the text of every warning the steps
    raised (an op without a deterministic kernel, cuBLAS's workspace alert).
    Last, what determinism costs: 3 rounds of one default and one
    deterministic step, in alternating order."""
    import copy
    import warnings

    import torch

    model = state.model
    n_anchors = 3 * sum((IMAGE_TRAIN // st) ** 2 for st in (4, 8, 16, 32, 64))
    noise = model.draw_sampler_noise(B, n_anchors, MAX_BOXES, torch.Generator().manual_seed(2))
    saved = (copy.deepcopy(model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
             state.step)

    def step():
        model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = saved[2]
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = ctl.train_step(state, batch, sampler_noise=noise)
        torch.cuda.synchronize()
        return losses, (time.perf_counter() - t) * 1e3

    def two_steps():
        runs = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                losses, ms = step()
                runs.append((losses, ms, {n: p.grad.detach().clone()
                                          for n, p in model.named_parameters()
                                          if p.grad is not None}))
        (l1, ms1, g1), (l2, ms2, g2) = runs
        differ = sorted(n for n in g1 if not torch.equal(g1[n], g2[n]))
        worst = max((float((g1[n] - g2[n]).abs().max() / g1[n].abs().max().clamp(min=1e-30)),
                     n) for n in differ) if differ else (0.0, None)
        return dict(grads=len(g1), grads_bitwise_different=len(differ),
                    grads_bitwise_equal=sorted(set(g1) - set(differ))[:32], worst_rel_diff=worst[0],
                    worst=worst[1], losses_bitwise_equal=l1 == l2, step_ms=[ms1, ms2],
                    warnings=sorted({str(w.message)[:400] for w in caught}))

    default = two_steps()
    torch.backends.cudnn.deterministic = True
    try:
        cudnn_only = two_steps()
    finally:
        torch.backends.cudnn.deterministic = False
    with deterministic_algorithms():
        deterministic = two_steps()
    rounds = []
    for r in range(3):
        pair = {}
        for mode in (("default", "deterministic") if r % 2 == 0
                     else ("deterministic", "default")):
            ctx = (deterministic_algorithms() if mode == "deterministic"
                   else contextlib.nullcontext())
            with ctx, warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pair[mode] = step()[1]
        rounds.append(pair)
    cost = statistics.median(p["deterministic"] / p["default"] - 1 for p in rounds)
    emit("train_repro", batch=B, default=default, cudnn_deterministic=cudnn_only,
         deterministic_algorithms=deterministic, step_ms_rounds=rounds,
         deterministic_cost_median=cost)


# softmax CE over a heatmap's positions has a gradient that sums to 0, the 2x
# bilinear upsample weighs every output 1 in all, so this bias's gradient is 0
# in exact arithmetic and only rounding is left on either side
ZERO_BY_CONSTRUCTION = ("roi_heads.keypoint_predictor.kps_score_lowres.bias",)


def train_vs_cpu_phase(dev) -> None:
    """Phase 5: one reduced step on the card and on the CPU, same weights and
    noise."""
    import copy

    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
    from pets_face_recognition_tpu_torch.weights import init_random_

    B, image = 2, 256
    budgets = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
                   box_batch_size_per_image=16)
    cpu_model = init_random_(keypointrcnn_resnet50_fpn(**budgets), 1)
    gpu_model = copy.deepcopy(cpu_model)
    batch = synthetic_keypoint_batch(B, image, image, MAX_BOXES, seed=1)
    n_anchors = 3 * sum((image // st) ** 2 for st in (4, 8, 16, 32, 64))
    noise = cpu_model.draw_sampler_noise(B, n_anchors, MAX_BOXES,
                                         torch.Generator().manual_seed(1))
    ctl = KeyPointsController()
    out = {}
    for name, model, device in (("gpu", gpu_model, dev), ("cpu", cpu_model, "cpu")):
        state = ctl.init_state(0, device, model=model)
        t = time.perf_counter()
        losses = ctl.train_step(state, batch, sampler_noise=noise)
        if name == "gpu":
            torch.cuda.synchronize()
        out[name] = (losses, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     time.perf_counter() - t)
    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["gpu"], out["cpu"]
    loss_rel = {k: abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    zero_abs = max(max(float(g_gpu[n].abs().max()), float(g_cpu[n].abs().max()))
                   for n in ZERO_BY_CONSTRUCTION)
    grad_rel = {n: float((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm())
                for n in g_cpu if n not in ZERO_BY_CONSTRUCTION}
    worst = max(grad_rel, key=grad_rel.get)
    emit("train_vs_cpu", batch=B, image=image, budgets=budgets, losses_gpu=l_gpu,
         losses_cpu=l_cpu, loss_rel_err=loss_rel, grad_rel_err_max=grad_rel[worst],
         grad_rel_err_worst=worst, zero_by_construction_abs=zero_abs,
         grad_tensors=len(grad_rel), step_s_gpu=t_gpu, step_s_cpu=t_cpu,
         tolerances=dict(loss_rel=1e-3, grad_rel_norm=5e-3, zero_by_construction_abs=1e-5))
    # the card and the CPU run other convolution algorithms and sum in other
    # orders (K4 too); both see the same samples. Gradients: the
    # worst tensor measured 9.5e-4 on an H100 (a trunk BN bias, which sums a
    # whole feature map), held at 5e-3 for other cuDNN algorithm choices
    bad = {k: v for k, v in loss_rel.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"losses differ from the CPU step: {bad}")
    if not grad_rel[worst] <= 5e-3:
        raise AssertionError(f"gradient {worst} differs from the CPU step: {grad_rel[worst]}")
    if not zero_abs <= 1e-5:
        raise AssertionError(f"zero-by-construction gradient is {zero_abs}")


KERNEL_ROWS = (
    ("warp_perspective_batch", ("warp_perspective_batch",), "csrc/warp.cu",
     "pets_face_recognition_tpu/ops/pallas_warp.py:152"),
    ("nms_keep_sorted_batch", ("nms_keep_sorted_batch",), "csrc/nms.cu",
     "pets_face_recognition_tpu/ops/pallas_nms.py:153"),
    ("multilevel_roi_align", ("multilevel_roi_align",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    ("multilevel_roi_align_backward", ("multilevel_roi_align_backward",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    # K4's pre-pass (sort keys and footprints), part of the same port of _roi_backward
    ("roi_footprints", ("roi_footprints",), "csrc/roi_align_backward.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    ("nms_keep_sorted_grid", ("nms_keep_sorted", "nms_keep_sorted_grid"), "csrc/nms.cu",
     "pets_face_recognition_tpu/ops/pallas_nms.py:75,191"),
)


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pets_face_recognition_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    t = time.perf_counter()
    path = kernels.build()
    kernels.library()
    emit("build", seconds=time.perf_counter() - t, library=str(path))

    rows = kernel_phase(dev)
    rows.update(train_kernel_phase(dev))   # K2 and K3 at the training shapes, K4, K5
    edge_phase(dev)
    launches = e2e_phase(dev, kernels, smi)
    train_launches = train_phase(dev, kernels, smi)
    train_vs_cpu_phase(dev)
    table = []
    for name, counted, src, replaces in KERNEL_ROWS:
        table.append(dict(rows[name], name=name, route="cuda",
                          source=f"pets_face_recognition_tpu_torch/{src}", replaces=replaces,
                          launches=sum(launches[k] + train_launches[k] for k in counted)))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in table]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
