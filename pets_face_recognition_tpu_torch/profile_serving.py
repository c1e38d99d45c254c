"""Profile the serving path or the training step on the GPU: device time by
kernel and by kind.

    python -m pets_face_recognition_tpu_torch.profile_serving [--batch 32] [--iters 3]
    python -m pets_face_recognition_tpu_torch.profile_serving --train [--batch 16] [--iters 2]

Serving: builds the serving models (full ResNet-50 width, seeded random
weights), warms up, then runs ``embed_batch`` ``--iters`` times under
``torch.profiler``. ``--train``: keypoint R-CNN ResNet-50-FPN training steps
(``KeyPointsController``, training defaults, SGD) on a seeded synthetic batch
of 640 x 640 images with 4 boxes, one warm-up step, then ``--iters`` steps
under the profiler. Float32, TF32 off. Prints JSON lines: the card, host wall
time per batch (or step) and peak memory, the device-busy share of the
profiled window (union of kernel intervals over its span), device time per
batch by kind (convolution, matrix product, the hand-written kernels, other),
the top kernels, and the device time per launch of each hand-written kernel.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .serving import EmbeddingService, build_serving_models

OWN_KERNELS = {"warp_perspective_kernel": "K1 warp",
               "nms_keep_sorted_batch_kernel": "K2 nms",
               "multilevel_roi_align_kernel": "K3 roi_align",
               "multilevel_roi_align_backward_kernel": "K4 roi_align_backward",
               "roi_footprints_kernel": "K4 pre-pass roi_footprints"}


def kind_of(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                              "cudnn", "xmma")):
        return "convolution"
    if "gemm" in low or "gemv" in low:
        return "matrix product"
    return "other"


def serving_step(batch: int):
    """``embed_batch`` on seeded uint8 320 x 320 images, full-width models."""
    detector, embedder, base = build_serving_models("cuda", seed=0)
    service = EmbeddingService(detector, embedder, base)
    g = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (batch, 320, 320, 3), generator=g,
                         dtype=torch.uint8).cuda()
    ok = torch.ones(batch, dtype=torch.bool, device="cuda")
    return lambda: service.embed_batch(imgs, ok)


def train_step(batch: int):
    """One ``KeyPointsController.train_step`` on a seeded synthetic batch."""
    from .data import synthetic_keypoint_batch
    from .engine.detector_controller import KeyPointsController

    ctl = KeyPointsController()
    state = ctl.init_state(seed=0, device="cuda")
    data = synthetic_keypoint_batch(batch, 640, 640, 4, seed=0)
    return lambda: ctl.train_step(state, data)


def busy_us(kernels) -> tuple[float, float]:
    """Union of the kernels' intervals and the span of the window, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, (spans[-1][1] - spans[0][0]) if spans else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true", help="profile training steps")
    ap.add_argument("--batch", type=int, default=None, help="default 32, or 16 with --train")
    ap.add_argument("--iters", type=int, default=None, help="default 3, or 2 with --train")
    args = ap.parse_args()
    batch = args.batch or (16 if args.train else 32)
    iters = args.iters or (2 if args.train else 3)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    step = train_step(batch) if args.train else serving_step(batch)
    for _ in range(1 if args.train else 2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
    busy, window = busy_us(kernels)
    by_kind: dict[str, float] = {}
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + us
        by_name.setdefault(e.name, []).append(us)
    per_batch = {k: v / iters / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    print(json.dumps({"card": card, "mode": "train" if args.train else "serving",
                      "batch": batch, "iters": iters, "wall_ms_per_batch": wall / iters * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "device_busy_share": busy / window if window else None,
                      "device_ms_per_batch": per_batch}), flush=True)
    print(json.dumps({"top_kernels": [
        {"name": n[:90], "ms_per_batch": sum(t) / iters / 1e3,
         "launches_per_batch": len(t) / iters} for n, t in top]}), flush=True)
    print(json.dumps({"own_kernels": {
        label: [round(t, 2) for n, ts in by_name.items() if key in n for t in ts]
        for key, label in OWN_KERNELS.items()}, "unit": "us per launch"}), flush=True)


if __name__ == "__main__":
    main()
