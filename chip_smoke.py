#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; exits 1 without a CUDA device (it never falls back to the CPU);
1. build: the one ``nvcc`` call over ``pets_face_recognition_tpu_torch/csrc``;
2. kernels: K1 warp, K2 NMS and K3 RoIAlign at the serving path's shapes
   (B = 8), each held against its plain PyTorch version on the card, and timed
   with CUDA events (median of 20 after warm-up) beside the plain version, the
   one library call that computes the same function where there is one, and
   its bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32);
3. end to end: ``build_serving_models`` at full ResNet-50 width with seeded
   random weights, ``EmbeddingService.embed_batch`` on seeded uint8 320x320
   images at B = 8 with the launch counts read around it, checks against the
   same models on the CPU on a B = 2 input, then crops/s at B = 32.

Then a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``, printed only if every phase passed. Every
number is float32 with TF32 off. A hang becomes a traceback and exit 1
through ``faulthandler``.
"""

from __future__ import annotations

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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def kernel_phase(dev, kernels_mod) -> list[dict]:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.ops import homography, nms, roi_align

    g = torch.Generator().manual_seed(0)
    rows = []

    # K1: (8, 320, 320, 3) -> (8, 224, 224, 3)
    images = torch.rand(B_KERNELS, IMAGE, IMAGE, 3, generator=g).to(dev)
    base = torch.tensor([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]])
    lms = similarity_landmarks(g, B_KERNELS, base, IMAGE).to(dev)
    Hs = homography.alignment_homographies(lms, base.to(dev))
    got = homography.warp_perspective_batch_cuda(images, Hs, (CROP, CROP))
    want = homography.warp_perspective_batch(images, Hs, (CROP, CROP))
    torch.cuda.synchronize()
    err, tol = max_err(got, want), 1e-4
    ms = cuda_ms(lambda: homography.warp_perspective_batch_cuda(images, Hs, (CROP, CROP)))
    plain = cuda_ms(lambda: homography.warp_perspective_batch(images, Hs, (CROP, CROP)))
    # the one library call: grid_sample, zero padding, on a grid from H^-1
    hinv = torch.linalg.inv(Hs)
    gy, gx = torch.meshgrid(torch.arange(CROP, device=dev, dtype=torch.float32),
                            torch.arange(CROP, device=dev, dtype=torch.float32),
                            indexing="ij")
    h = hinv[:, :, :, None, None]
    den = h[:, 2, 0] * gx + h[:, 2, 1] * gy + h[:, 2, 2]
    sx = (h[:, 0, 0] * gx + h[:, 0, 1] * gy + h[:, 0, 2]) / den
    sy = (h[:, 1, 0] * gx + h[:, 1, 1] * gy + h[:, 1, 2]) / den
    grid = torch.stack([2 * sx / (IMAGE - 1) - 1, 2 * sy / (IMAGE - 1) - 1], -1)
    nchw = images.permute(0, 3, 1, 2)
    lib_out = torch.nn.functional.grid_sample(nchw, grid, padding_mode="zeros",
                                              align_corners=True)
    lib_err = max_err(lib_out.permute(0, 2, 3, 1), want)
    lib_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        nchw, grid, padding_mode="zeros", align_corners=True))
    n_bytes = images.numel() * 4 + Hs.numel() * 4 + got.numel() * 4
    n_flops = B_KERNELS * CROP * CROP * (24 + 7 * 3)
    b, by = bound_ms(n_bytes, n_flops)
    emit("kernel", name="K1 warp_perspective_batch", shape=list(images.shape),
         max_abs_err=err, atol=tol, ms=ms, plain_ms=plain, library_ms=lib_ms,
         library="grid_sample(zeros, align_corners=True)", library_max_abs_err=lib_err,
         bound_ms=b, bound_by=by)
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
    rows.append(dict(name="warp_perspective_batch", route="cuda",
                     source="pets_face_recognition_tpu_torch/csrc/warp.cu",
                     replaces="pets_face_recognition_tpu/ops/pallas_warp.py:152",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib_ms))

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
    plain = cuda_ms(lambda: nms.nms_keep_sorted_batch(boxes, valid, 0.7), iters=5)
    # IoUs this data needs: each live pivot against the live boxes after it
    b_np, v_np = boxes.cpu().numpy(), valid.cpu().numpy()
    n_iou = 0
    for gi in range(G):
        x1, y1, x2, y2 = b_np[gi].T
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        alive = v_np[gi].copy()
        for i in range(K):
            if not alive[i]:
                continue
            n_iou += int(alive[i + 1:].sum())
            inter = (np.maximum(np.minimum(x2, x2[i]) - np.maximum(x1, x1[i]), 0)
                     * np.maximum(np.minimum(y2, y2[i]) - np.maximum(y1, y1[i]), 0))
            union = area + area[i] - inter
            iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
            sup = iou > np.float32(0.7)
            sup[: i + 1] = False
            alive &= ~sup
    n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
    b, by = bound_ms(n_bytes, n_iou * 13)
    emit("kernel", name="K2 nms_keep_sorted_batch", shape=[G, K, 4], mismatches=n_diff,
         kept=int(got.sum()), ms=ms, plain_ms=plain, library_ms=None,
         library="none (no torchvision)", bound_ms=b, bound_by=by, ious=n_iou,
         sequential_steps=K)
    if n_diff:
        raise AssertionError(f"K2 keep mask differs from the plain version in {n_diff}")
    rows.append(dict(name="nms_keep_sorted_batch", route="cuda",
                     source="pets_face_recognition_tpu_torch/csrc/nms.cu",
                     replaces="pets_face_recognition_tpu/ops/pallas_nms.py:153",
                     max_abs_err=float(n_diff), ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=None))

    # K3: p2..p5 of a 320 image, C = 256; box RoIs 16/image at 7x7, keypoint
    # RoIs 1/image at 14x14. Boxes include ones overhanging the image and wide
    # ones (5:1) that the TPU kernel's fixed windows would clamp.
    C = 256
    levels = [torch.randn(B_KERNELS, s, s, C, generator=g).to(dev) for s in (80, 40, 20, 10)]
    strides = (4, 8, 16, 32)

    def make_rois(n):
        cx = torch.rand(n, generator=g) * 360 - 20
        cy = torch.rand(n, generator=g) * 360 - 20
        size = 16 * 2 ** (torch.rand(n, generator=g) * 4.5)
        aspect = torch.where(torch.rand(n, generator=g) < 0.25, torch.tensor(5.0),
                             0.5 + torch.rand(n, generator=g))
        w, h = size * aspect.sqrt(), size / aspect.sqrt()
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)

    k3_ms = k3_plain = k3_bound_b = k3_flops = 0.0
    k3_err = 0.0
    for n_per, out in ((16, 7), (1, 14)):
        rois = make_rois(B_KERNELS * n_per).to(dev)
        bidx = torch.arange(B_KERNELS, device=dev).repeat_interleave(n_per).to(torch.int32)
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args)
        want = roi_align.multilevel_roi_align(*args)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), 1e-4
        k3_err = max(k3_err, err)
        ms = cuda_ms(lambda: roi_align.multilevel_roi_align_cuda(*args))
        plain = cuda_ms(lambda: roi_align.multilevel_roi_align(*args))
        cells = touched_cells(levels, rois, bidx, (out, out), strides)
        n_bytes = cells * C * 4 + rois.numel() * 4 + bidx.numel() * 4 + got.numel() * 4
        n_flops = got.numel() * (8 * 4 + 1)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name=f"K3 multilevel_roi_align {out}x{out}", rois=rois.shape[0],
             max_abs_err=err, atol=tol, ms=ms, plain_ms=plain, library_ms=None,
             library="none (no torchvision)", bound_ms=b, bound_by=by,
             touched_cells=cells)
        if not err <= tol:
            raise AssertionError(f"K3 {out}x{out} disagrees: {err} > {tol}")
        k3_ms += ms
        k3_plain += plain
        k3_bound_b += n_bytes
        k3_flops += n_flops
    b, by = bound_ms(k3_bound_b, k3_flops)
    rows.append(dict(name="multilevel_roi_align", route="cuda",
                     source="pets_face_recognition_tpu_torch/csrc/roi_align.cu",
                     replaces="pets_face_recognition_tpu/ops/pallas_roi_align.py:120",
                     max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=b,
                     bound_by=by, library_ms=None))
    return rows


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


def e2e_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase 3: the serving path at full width, its launch counts and checks."""
    import torch
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

    kernels_mod.reset_launch_counts()
    emb, valid = service.embed_batch(imgs8, ok8)
    torch.cuda.synchronize()
    launches = kernels_mod.launch_counts()
    if emb.shape != (B_KERNELS, 512) or valid.shape != (B_KERNELS,):
        raise AssertionError(f"bad shapes {tuple(emb.shape)} {tuple(valid.shape)}")
    if not bool(torch.isfinite(emb[valid]).all()):
        raise AssertionError("non-finite embeddings on valid rows")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    emit("e2e", batch=B_KERNELS, launches=launches, valid_rows=int(valid.sum()),
         model_build_s=build_s)

    # reference: the same seeded models on the CPU (plain versions), B = 2
    det_cpu, emb_cpu, base_cpu = build_serving_models(device="cpu", seed=0)
    x = imgs8[:2].float() / 255.0
    with torch.inference_mode():
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
         precision="float32, cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False",
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    rows = kernel_phase(dev, kernels)
    launches = e2e_phase(dev, kernels, smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
