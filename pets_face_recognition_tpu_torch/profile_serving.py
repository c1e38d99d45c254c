"""Profile the serving path on the GPU: device time by kernel and by kind.

    python -m pets_face_recognition_tpu_torch.profile_serving [--batch 32] [--iters 3]

Builds the serving models (full ResNet-50 width, seeded random weights, float32,
TF32 off), warms up, then runs ``embed_batch`` ``--iters`` times under
``torch.profiler``. Prints JSON lines: the card, host wall time per batch, the
device-busy share of the profiled window (union of kernel intervals over its
span), device time per batch by kind (convolution, matrix product, the three
hand-written kernels, other), the top kernels, and the device time per launch
of each hand-written kernel. Needs a CUDA device.
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
               "multilevel_roi_align_kernel": "K3 roi_align"}


def kind_of(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("conv", "fprop", "dgrad", "implicit", "winograd", "cudnn",
                              "xmma")):
        return "convolution"
    if "gemm" in low or "gemv" in low:
        return "matrix product"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    detector, embedder, base = build_serving_models("cuda", seed=0)
    service = EmbeddingService(detector, embedder, base)
    g = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (args.batch, 320, 320, 3), generator=g,
                         dtype=torch.uint8).cuda()
    ok = torch.ones(args.batch, dtype=torch.bool, device="cuda")
    for _ in range(2):
        service.embed_batch(imgs, ok)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
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
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0

    by_kind: dict[str, float] = {}
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + us
        by_name.setdefault(e.name, []).append(us)
    per_batch = {k: v / args.iters / 1e3 for k, v in sorted(by_kind.items(),
                                                            key=lambda kv: -kv[1])}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    print(json.dumps({"card": card, "batch": args.batch, "iters": args.iters,
                      "wall_ms_per_batch": wall / args.iters * 1e3,
                      "device_busy_share": busy / window if window else None,
                      "device_ms_per_batch": per_batch}), flush=True)
    print(json.dumps({"top_kernels": [
        {"name": n[:90], "ms_per_batch": sum(t) / args.iters / 1e3,
         "launches_per_batch": len(t) / args.iters} for n, t in top]}), flush=True)
    print(json.dumps({"own_kernels": {
        label: [round(t, 2) for n, ts in by_name.items() if key in n for t in ts]
        for key, label in OWN_KERNELS.items()}, "unit": "us per launch"}), flush=True)


if __name__ == "__main__":
    main()
