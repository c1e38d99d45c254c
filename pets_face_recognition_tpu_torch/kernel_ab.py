"""Time kernels K1 (warp), K2 (NMS), K3 (RoIAlign forward) and K4 (its
backward) of one tree of the port on the GPU, so that two trees can be compared
in one run on one card.

    python pets_face_recognition_tpu_torch/kernel_ab.py [--tree DIR] [--label NAME]
        [--only k1]

Imports ``pets_face_recognition_tpu_torch`` from ``--tree`` (default: the tree
that holds this file), builds its kernels and runs each wrapper on seeded
random inputs at the shapes of ``chip_smoke.py``: K1 in its three compute
modes on 320 x 320 images to 224 x 224 crops at B = 8 and 32 (the served
batch), beside ``grid_sample`` in float32 on a grid built beforehand
(``--only k1`` runs these rows alone); K2 at 40 groups of 128 boxes
(serving, B = 8) and 80 of 2000 (training), the latter also with only the
first 1000 boxes of a group valid, as the step's padded small levels give; K3
on p2-p5 of 320 x 320 images (B = 8: 128 RoIs at 7 x 7 and 8 at 14 x 14;
B = 32: 512 and 32) and of 16 images of 640 x 640 (8192 RoIs at 7 x 7, 2048 at
14 x 14), C = 256, on float32 levels and on bfloat16 ones (K3-bf16, with a
float32 output and, where the tree has ``out_dtype``, a bfloat16 one); K4 in
float32 and with bfloat16 operands (K4-bf16: a float32 cotangent and, where
the tree reads one, a bfloat16 one; bfloat16 gradients) at the 640 x 640
shapes. Each is held against its plain version (keep-mask mismatches,
largest absolute error) and timed: the wrapper's median CUDA-event time, its
host time a call back to back, and its kernels' device time per call from
``torch.profiler`` (for K2 also by kernel). K3's float32 lines add the bytes
that a kernel sharing no data between RoIs must move (each RoI's distinct
tapped cells, and the output) and that over the device time. Prints one JSON
line per shape. Compare trees only within one run, in turns (old, new, new,
old). Needs a CUDA device. ``chip_smoke.py`` times its kernels with the same
helpers (``cuda_ms``, ``device_us``) on the same RoIs (``random_rois``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


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


def host_us(fn, iters: int = 100, warmup: int = 5, repeats: int = 5) -> float:
    """Host time per call of ``fn()`` in us: the median over ``repeats`` runs
    of ``iters`` calls back to back after ``warmup`` calls, without waiting
    for the device inside a run (the host's own jitter moves one run by tens
    of percent)."""
    import torch

    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t) / iters * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def device_us_by_kernel(fn, kernel_name: str, iters: int = 10, strict: bool = True,
                        attempts: int = 5) -> dict[str, float] | None:
    """Device time per call of ``fn()`` of each kernel whose name holds
    ``kernel_name`` (every kernel for ""), in us: the median of its launches
    over ``iters`` calls (after one) under ``torch.profiler``. The profiler may
    miss the window's first launch, now and then most or every launch of a
    window, and on one H100 machine it did so in three windows running: such
    a window is profiled again, up to ``attempts`` windows. Each call must
    launch each such kernel once; else raise, or return None when not
    ``strict``."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.name:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        counts = [len(t) for t in by_name.values()]
        if counts and all(iters // 2 <= n <= iters for n in counts):
            return {name: statistics.median(t) for name, t in by_name.items()}
        seen.append(counts)
    if not strict:
        return None
    raise AssertionError(f"profiler saw {seen} launches of {kernel_name} in {attempts} "
                         f"windows of {iters} calls")


def device_us(fn, kernel_name: str, **kw) -> float | None:
    """:func:`device_us_by_kernel` summed over the kernels (K2 launches two a
    call)."""
    by_kernel = device_us_by_kernel(fn, kernel_name, **kw)
    return None if by_kernel is None else sum(by_kernel.values())


def random_rois(g, n: int, image: int, max_log2: float):
    """``(n, 4)`` RoIs around the image: sizes 16 * 2 ** U(0, max_log2), a
    quarter of them 5:1 wide, centres up to 1/16 of the image off its edges."""
    import torch

    margin = image / 16
    cx = torch.rand(n, generator=g) * (image + 2 * margin) - margin
    cy = torch.rand(n, generator=g) * (image + 2 * margin) - margin
    size = 16 * 2 ** (torch.rand(n, generator=g) * max_log2)
    aspect = torch.where(torch.rand(n, generator=g) < 0.25, torch.tensor(5.0),
                         0.5 + torch.rand(n, generator=g))
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def roi_distinct_cells(levels, rois, out: int, strides, s: int = 2) -> int:
    """Sum over the RoIs of the distinct cells that each one's taps read (its
    in-bounds sample rows' taps times its sample columns' taps): what a kernel
    that shares no data between RoIs must bring to the SM at least."""
    import torch
    from pets_face_recognition_tpu_torch.ops.roi_align import _sample_offsets, roi_levels

    lvl = roi_levels(rois, 2, 5).long()
    total = 0
    for li, f in enumerate(levels):
        sel = lvl == li
        if not sel.any():
            continue
        r = rois[sel] * (1.0 / strides[li])
        counts = []
        for lo, hi, lim in ((r[:, 1], r[:, 3], f.shape[1]), (r[:, 0], r[:, 2], f.shape[2])):
            bins = (hi - lo).clamp(min=1.0) / out
            pos = lo[:, None] + _sample_offsets(out, s, rois.device)[None] * bins[:, None]
            ok = (pos > -1) & (pos < lim)
            low = pos.clamp(min=0).floor().clamp(max=lim - 1)
            taps = torch.cat([torch.where(ok, low, -1.0),
                              torch.where(ok, (low + 1).clamp(max=lim - 1), -1.0)], 1)
            taps = taps.sort(1).values
            new = torch.cat([taps[:, :1] >= 0, (taps[:, 1:] != taps[:, :-1]) & (taps[:, 1:] >= 0)], 1)
            counts.append(new.sum(1))
        total += int((counts[0] * counts[1]).sum())
    return total


def similarity_landmarks(g, B: int, base, image: int):
    """Well-formed landmarks: seeded similarity transforms of the base points
    (scale 0.6-1.4, rotation within 15 degrees, centre within 40 px of the
    image's)."""
    import math

    import torch

    scale = 0.6 + 0.8 * torch.rand(B, generator=g)
    theta = (torch.rand(B, generator=g) - 0.5) * math.radians(30.0)
    center = image / 2 + (torch.rand(B, 2, generator=g) - 0.5) * 80.0
    rot = torch.stack([torch.stack([theta.cos(), -theta.sin()], -1),
                       torch.stack([theta.sin(), theta.cos()], -1)], -2)
    rel = base.cpu() - base.cpu().mean(0)
    return (scale[:, None, None] * rel[None] @ rot.transpose(1, 2)) + center[:, None, :]


def grid_sample_grid(Hs, hw: tuple[int, int], crop: tuple[int, int]):
    """``grid_sample``'s ``(B, out_h, out_w, 2)`` grid (align_corners=True) for
    a ``crop = (out_h, out_w)`` from the maps ``Hs`` on ``hw = (H, W)`` images:
    each output pixel's source position ``H^-1 @ (x, y, 1)``."""
    import torch

    hinv = torch.linalg.inv(Hs)
    gy, gx = torch.meshgrid(torch.arange(crop[0], device=Hs.device, dtype=torch.float32),
                            torch.arange(crop[1], device=Hs.device, dtype=torch.float32),
                            indexing="ij")
    h = hinv[:, :, :, None, None]
    den = h[:, 2, 0] * gx + h[:, 2, 1] * gy + h[:, 2, 2]
    sx = (h[:, 0, 0] * gx + h[:, 0, 1] * gy + h[:, 0, 2]) / den
    sy = (h[:, 1, 0] * gx + h[:, 1, 1] * gy + h[:, 1, 2]) / den
    return torch.stack([2 * sx / (hw[1] - 1) - 1, 2 * sy / (hw[0] - 1) - 1], -1)


def warp_read_bytes(images, Hs, crop: tuple[int, int]) -> int:
    """Bytes that K1 must read from the source on these inputs: each image's
    distinct pixels under the crop's bilinear taps that lie inside the image
    and carry a nonzero weight (the plain version's sample positions), C
    float32 values each."""
    import torch
    from pets_face_recognition_tpu_torch.ops.homography import (_sample_coords,
                                                                invert_homographies)

    B, H, W, C = images.shape
    sx, sy = _sample_coords(invert_homographies(Hs), crop)
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


K1_IMAGE, K1_CROP = 320, 224
K1_BASE = ((70.0, 92.0), (154.0, 92.0), (112.0, 160.0))   # serving.py's base points
HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM, NVIDIA data sheet


def k1_rows(g, dev, label: str) -> None:
    """K1 in float32, bfloat16 and int8 at B = 8 and 32 on seeded alignment
    maps (320 x 320 -> 224 x 224, C = 3, float32 out): bits against the plain
    version, wrapper ms, host us a call and the kernel's device us, beside
    ``grid_sample`` in float32 on a grid built beforehand (the same three
    readings) and the byte bound (the source pixels the taps read, the maps,
    the crops)."""
    import torch
    from pets_face_recognition_tpu_torch.ops import homography

    crop = (K1_CROP, K1_CROP)
    base = torch.tensor(K1_BASE)
    for B in (8, 32):
        images = torch.rand(B, K1_IMAGE, K1_IMAGE, 3, generator=g).to(dev)
        Hs = homography.alignment_homographies(
            similarity_landmarks(g, B, base, K1_IMAGE).to(dev), base.to(dev))
        n_bytes = (warp_read_bytes(images, Hs, crop) + Hs.numel() * 4
                   + B * K1_CROP * K1_CROP * 3 * 4)
        nchw = images.permute(0, 3, 1, 2)
        grid = grid_sample_grid(Hs, (K1_IMAGE, K1_IMAGE), crop)
        lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw, grid, padding_mode="zeros", align_corners=True)
        print(json.dumps({"tree": label, "kernel": "grid_sample", "images": B,
                          "ms": cuda_ms(lib), "host_us": host_us(lib),
                          "device_us": device_us(lib, "", strict=False)}),
              flush=True)
        for name, cd in (("K1", torch.float32), ("K1-bf16", torch.bfloat16),
                         ("K1-int8", torch.int8)):
            fn = lambda: homography.warp_perspective_batch_cuda(  # noqa: E731
                images, Hs, crop, cd)
            err = float((fn() - homography.warp_perspective_batch(images, Hs, crop, cd))
                        .abs().max())
            print(json.dumps({"tree": label, "kernel": name, "images": B,
                              "max_abs_err": err, "ms": cuda_ms(fn), "host_us": host_us(fn),
                              "device_us": device_us(fn, "warp_perspective", strict=False),
                              "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6}),
                  flush=True)
        del images, nchw, grid


def k4_rows(g, dev, label: str, C: int, strides, bf16_cotangent: bool) -> None:
    """K4 in float32 and K4-bf16 on 16 images of 640 x 640 (8192 RoIs at 7 x
    7, 2048 at 14 x 14): error against the plain version, wrapper ms, host us
    and the backward kernel's device us; K4-bf16 with a float32 cotangent and,
    where ``bf16_cotangent``, a bfloat16 one."""
    import torch
    from pets_face_recognition_tpu_torch.ops import roi_align

    B, image, bf16 = 16, 640, torch.bfloat16
    shapes = [(B, image // s, image // s, C) for s in strides]
    for n_per, out in ((512, 7), (128, 14)):
        n = B * n_per
        rois = random_rois(g, n, image, 5.0).to(dev)
        bidx = torch.arange(B, device=dev).repeat_interleave(n_per).to(torch.int32)
        grad = torch.randn(n, out, out, C, generator=g).to(dev)
        cases = [("K4", grad, torch.float32), ("K4-bf16", grad, bf16)]
        if bf16_cotangent:
            cases.append(("K4-bf16", grad.to(bf16), bf16))
        for name, gr, dtype in cases:
            args = (gr, shapes, rois, bidx, (out, out), strides)
            fn = lambda: roi_align.multilevel_roi_align_backward_cuda(  # noqa: E731
                *args, dtype=dtype)
            plain = (roi_align.multilevel_roi_align_backward_bf16 if dtype == bf16
                     else roi_align.multilevel_roi_align_backward)(*args)
            err = max(float((a.float() - w.to(dtype).float()).abs().max())
                      for a, w in zip(fn(), plain))
            scale = max(float(w.abs().max()) for w in plain)
            del plain
            print(json.dumps({"tree": label, "kernel": name, "rois": n, "out": out,
                              "cotangent": str(gr.dtype), "max_abs_err": err,
                              "grad_max_abs": scale, "ms": cuda_ms(fn, iters=10),
                              "host_us": host_us(fn, iters=20),
                              "device_us": device_us(fn, "multilevel_roi_align_backward",
                                                     strict=False, iters=5)}),
                  flush=True)
        del grad, cases
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", choices=("k1",), default=None)
    args = ap.parse_args()
    # the tree, not this file's folder (python put it first), is where the
    # package comes from
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(here)]
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from pets_face_recognition_tpu_torch import kernels
    from pets_face_recognition_tpu_torch.ops import nms, roi_align

    label = args.label or args.tree
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.library()
    print(json.dumps({"tree": label, "package": kernels.__file__, "card": card}), flush=True)
    dev = torch.device("cuda", 0)

    k1_rows(torch.Generator().manual_seed(0), dev, label)
    if args.only == "k1":
        return 0
    g = torch.Generator().manual_seed(0)
    for G, K, image, max_log2, n_valid in ((40, 128, 320, 3.0, 128), (80, 2000, 640, 4.0, 2000),
                                           (80, 2000, 640, 4.0, 1000)):
        boxes = random_rois(g, G * K, image, max_log2).reshape(G, K, 4).contiguous().to(dev)
        valid = ((torch.rand(G, K, generator=g) > 0.1) & (torch.arange(K) < n_valid)).to(dev)
        fn = lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7)  # noqa: E731
        want = nms.nms_keep_sorted_batch(boxes, valid, 0.7)
        got = fn()
        split = device_us_by_kernel(fn, "nms_keep_sorted")
        print(json.dumps({"tree": label, "kernel": "K2", "groups": G, "boxes": K,
                          "valid": int(valid.sum()),
                          "mismatches": int((got != want).sum()), "kept": int(want.sum()),
                          "ms": cuda_ms(fn), "device_us": sum(split.values()),
                          "device_us_by_kernel": split}),
              flush=True)

    C, strides = 256, (4, 8, 16, 32)
    bf16 = torch.bfloat16
    has_out_dtype = "out_dtype" in inspect.signature(roi_align.multilevel_roi_align_cuda).parameters
    for B, image, counts in ((8, 320, ((16, 7), (1, 14))), (32, 320, ((16, 7), (1, 14))),
                             (16, 640, ((512, 7), (128, 14)))):
        levels = [torch.randn(B, image // s, image // s, C, generator=g).to(dev) for s in strides]
        levels_b = [f.to(bf16) for f in levels]
        for n_per, out in counts:
            rois = random_rois(g, B * n_per, image, 5.0 if image == 640 else 4.5).to(dev)
            bidx = torch.arange(B, device=dev).repeat_interleave(n_per).to(torch.int32)
            a = (levels, rois, bidx, (out, out), strides)
            fn = lambda: roi_align.multilevel_roi_align_cuda(*a)  # noqa: E731
            err = float((fn() - roi_align.multilevel_roi_align(*a)).abs().max())
            us = device_us(fn, "multilevel_roi_align_kernel")
            cells = roi_distinct_cells(levels, rois, out, strides)
            per_roi_bytes = cells * C * 4 + rois.shape[0] * out * out * C * 4
            print(json.dumps({"tree": label, "kernel": "K3", "images": B, "image": image,
                              "rois": rois.shape[0], "out": out, "max_abs_err": err,
                              "ms": cuda_ms(fn), "host_us": host_us(fn), "device_us": us,
                              "per_roi_distinct_bytes": per_roi_bytes,
                              "per_roi_tb_per_s": per_roi_bytes / us / 1e6 if us else None}),
                  flush=True)
            ab = (levels_b,) + a[1:]
            want = roi_align.multilevel_roi_align_bf16(*ab)
            for out_dtype in (torch.float32, bf16) if has_out_dtype else (torch.float32,):
                kw = {"out_dtype": out_dtype} if has_out_dtype else {}
                fn = lambda: roi_align.multilevel_roi_align_cuda(*ab, **kw)  # noqa: E731
                err = float((fn().float() - want.to(out_dtype).float()).abs().max())
                print(json.dumps({"tree": label, "kernel": "K3-bf16", "images": B,
                                  "image": image, "rois": rois.shape[0], "out": out,
                                  "out_dtype": str(out_dtype), "max_abs_err": err,
                                  "value_scale": float(want.abs().max()), "ms": cuda_ms(fn),
                                  "host_us": host_us(fn),
                                  "device_us": device_us(fn, "multilevel_roi_align_kernel",
                                                         strict=False)}),
                      flush=True)
            del want
        del levels, levels_b
    k4_rows(g, dev, label, C, strides, has_out_dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
