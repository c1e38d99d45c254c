"""Profile the serving path or the training step on the GPU: device time by
kernel and by kind.

    python -m pets_face_recognition_tpu_torch.profile_serving [--batch 32] [--iters 3]
    python -m pets_face_recognition_tpu_torch.profile_serving --train [--batch 16] [--iters 2]
    ... [--detector resnet50|mobile]

Serving: builds the serving models (full ResNet-50 width, seeded random
weights), warms up, then runs ``embed_batch`` ``--iters`` times under
``torch.profiler``. ``--train``: keypoint R-CNN ResNet-50-FPN training steps
(``KeyPointsController``, training defaults, SGD) on a seeded synthetic batch
of 640 x 640 images with 4 boxes, one warm-up step, then ``--iters`` steps
under the profiler. ``--detector mobile`` serves the MobileNetV3-Large
detector, or trains it with live BatchNorm (the keypoint config's
``arch="mobile"``). Before the profiled window, one unprofiled pass reads
each model part's device span (trunk, its depthwise convolutions, FPN, RPN
head, box and keypoint heads, the embedder; forward and, in training,
backward) with CUDA events. Float32, TF32 off. Prints JSON lines: the card,
host wall time per batch (or step) and peak memory, the device-busy share of the
profiled window (union of kernel intervals over its span), device time per
batch by kind (depthwise convolution, convolution, matrix product, the
hand-written kernels, other), the parts' spans, each hand-written kernel's
launches per batch,
the top kernels, the device time per launch of each hand-written kernel, and
for each call of K2 (NMS) in the profiled window its device time (both
passes) beside the work its data gave a greedy sweep: valid boxes, kept
boxes, the IoUs of kept pivots against boxes still alive, and the columns a
sweep that tests every later box visits (every box after each kept pivot), in
all and in the busiest group. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from .ops.nms import suppress_matrix
from .serving import EmbeddingService, build_serving_models

# K2's kernels share the prefix "nms_keep_sorted_batch"
K2_PREFIX = "nms_keep_sorted_batch"
# K1's float32 kernel and its bfloat16 and int8 tiled one share the prefix
OWN_KERNELS = {"warp_perspective_": "K1 warp",
               K2_PREFIX: "K2 nms",
               "multilevel_roi_align_kernel": "K3 roi_align",
               "multilevel_roi_align_backward_kernel": "K4 roi_align_backward",
               "multilevel_roi_align_backward_bf16_mma_kernel": "K4-bf16 roi_align_backward",
               "roi_footprints_kernel": "K4 pre-pass roi_footprints"}


def nms_work(boxes, valid, keep, thr: float, chunk: int = 8) -> dict[str, torch.Tensor]:
    """Work that a greedy sweep does on these inputs, per group ``(G,)``:
    ``ious``, for each kept pivot i the boxes j > i still alive at step i
    (valid, and first suppressed at step i or later); ``columns``, for each
    kept pivot i every box after it (K - 1 - i); ``valid`` and ``kept``."""
    G, K = keep.shape
    i = torch.arange(K, device=boxes.device)
    later = i[None, :] > i[:, None]                                 # [i, j]
    ious = []
    for s in range(0, G, chunk):
        b, v, k = boxes[s:s + chunk], valid[s:s + chunk], keep[s:s + chunk]
        sup = suppress_matrix(b, thr) & k[:, :, None]               # [g, i, j]
        first = torch.where(sup.any(1), sup.float().argmax(1), K)   # step j dies
        alive_at = later & v[:, None, :] & (first[:, None, :] >= i[None, :, None])
        ious.append((alive_at & k[:, :, None]).sum((1, 2)))
    return {"valid": valid.sum(1), "kept": keep.sum(1), "ious": torch.cat(ious),
            "columns": (keep * (K - 1 - i)).sum(1)}


def record_nms_calls(calls: list) -> None:
    """Make the RPN's K2 call append copies of its inputs and keep mask to
    ``calls``."""
    from .models import rpn

    inner = rpn.nms_keep_sorted_batch_cuda

    def recording(boxes, valid, thr):
        keep = inner(boxes, valid, thr)
        calls.append((boxes.clone(), valid.clone(), keep.clone(), thr))
        return keep

    rpn.nms_keep_sorted_batch_cuda = recording


def kind_of(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return label
    low = name.lower()
    # PyTorch's own depthwise kernels and cuDNN's grouped / depthwise ones
    if any(k in low for k in ("depthwise", "dwconv", "grouped")):
        return "depthwise convolution"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                              "cudnn", "xmma")):
        return "convolution"
    if "gemm" in low or "gemv" in low:
        return "matrix product"
    return "other"


def model_parts(detector, embedder=None) -> dict[str, list[torch.nn.Module]]:
    """The modules whose device spans ``module_spans`` reads, by part; for a
    MobileNetV3 trunk also its 15 depthwise convolutions as one part."""
    heads = detector.roi_heads
    parts = {"trunk": [detector.backbone.body], "fpn": [detector.backbone.fpn],
             "rpn head": [detector.rpn], "box head": [heads.box_head],
             "box predictor": [heads.box_predictor], "keypoint head": [heads.keypoint_head],
             "keypoint predictor": [heads.keypoint_predictor]}
    blocks = getattr(detector.backbone.body, "blocks", None)
    if blocks is not None:
        parts["depthwise convolutions"] = [b.dwconv for b in blocks]
    if embedder is not None:
        parts["embedder"] = [embedder]
    return parts


@contextlib.contextmanager
def module_spans(parts: dict[str, list[torch.nn.Module]], backward: bool = False):
    """CUDA events around each part's modules' forward (and backward) calls:
    yields a dict that holds, after the block, each part's summed device span
    in ms (from its first kernel's start to its last one's end, idle gaps
    within included) per direction. Spans of one part do not nest."""
    marks: dict[str, list] = {}
    handles = []

    def opener(key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(key, []).append([ev, None])
        return hook

    def closer(key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[key][-1][1] = ev
        return hook

    for name, mods in parts.items():
        for mod in mods:
            handles += [mod.register_forward_pre_hook(opener(f"{name} forward")),
                        mod.register_forward_hook(closer(f"{name} forward"))]
            if backward:
                handles += [mod.register_full_backward_pre_hook(opener(f"{name} backward")),
                            mod.register_full_backward_hook(closer(f"{name} backward"))]
    out: dict[str, float] = {}
    try:
        yield out
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    for key, pairs in marks.items():
        out[key] = sum(a.elapsed_time(b) for a, b in pairs if b is not None)


def serving_step(batch: int, detector_kind: str = "resnet50"):
    """``embed_batch`` on seeded uint8 320 x 320 images, full-width models;
    returns the step and the models' parts."""
    detector, embedder, base = build_serving_models("cuda", seed=0,
                                                    detector_kind=detector_kind)
    service = EmbeddingService(detector, embedder, base)
    g = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (batch, 320, 320, 3), generator=g,
                         dtype=torch.uint8).cuda()
    ok = torch.ones(batch, dtype=torch.bool, device="cuda")
    return (lambda: service.embed_batch(imgs, ok)), model_parts(detector, embedder)


def train_step(batch: int, arch: str = "resnet50"):
    """One ``KeyPointsController.train_step`` of the keypoint config's
    ``arch`` model on a seeded synthetic batch; returns the step and the
    model's parts."""
    from .data import synthetic_keypoint_batch
    from .engine.detector_controller import KeyPointsController

    ctl = KeyPointsController(arch=arch)
    state = ctl.init_state(seed=0, device="cuda")
    data = synthetic_keypoint_batch(batch, 640, 640, 4, seed=0)
    return (lambda: ctl.train_step(state, data)), model_parts(state.model)


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
    ap.add_argument("--detector", choices=("resnet50", "mobile"), default="resnet50",
                    help="the detector served or trained (mobile: MobileNetV3-Large, "
                         "live BatchNorm in training)")
    args = ap.parse_args()
    batch = args.batch or (16 if args.train else 32)
    iters = args.iters or (2 if args.train else 3)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    step, parts = (train_step(batch, args.detector) if args.train
                   else serving_step(batch, args.detector))
    for _ in range(1 if args.train else 2):
        step()
    torch.cuda.synchronize()
    with module_spans(parts, backward=args.train) as spans:
        for _ in range(iters):
            step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    calls = []
    record_nms_calls(calls)
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
                      "detector": args.detector,
                      "batch": batch, "iters": iters, "wall_ms_per_batch": wall / iters * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "device_busy_share": busy / window if window else None,
                      "device_ms_per_batch": per_batch}), flush=True)
    print(json.dumps({"top_kernels": [
        {"name": n[:90], "ms_per_batch": sum(t) / iters / 1e3,
         "launches_per_batch": len(t) / iters} for n, t in top]}), flush=True)
    print(json.dumps({"part_span_ms_per_batch": {k: v / iters for k, v in spans.items()},
                      "note": "CUDA events around each module's forward (and backward) "
                              "calls in an unprofiled pass; spans include idle gaps"}),
          flush=True)
    print(json.dumps({"own_kernel_launches_per_batch": {
        label: sum(len(ts) for n, ts in by_name.items() if key in n) / iters
        for key, label in OWN_KERNELS.items()}}), flush=True)
    print(json.dumps({"own_kernels": {
        label: [round(t, 2) for n, ts in by_name.items() if key in n for t in ts]
        for key, label in OWN_KERNELS.items()}, "unit": "us per launch"}), flush=True)
    # K2 calls in order: the device time of each call's kernels (one or more
    # passes) beside the work its data gave a greedy sweep
    k2 = sorted((e for e in kernels if K2_PREFIX in e.name), key=lambda e: e.time_range.start)
    per_call = len({e.name for e in k2}) or 1
    us = [sum(e.time_range.elapsed_us() for e in k2[n:n + per_call])
          for n in range(0, len(k2), per_call)]
    rows = []
    for n, (boxes, valid, keep, thr) in enumerate(calls):
        w = nms_work(boxes, valid, keep, thr)
        rows.append({"device_us": us[n] if len(us) == len(calls) else None,
                     "groups": keep.shape[0], "boxes_per_group": keep.shape[1],
                     **{f"{k}": int(v.sum()) for k, v in w.items()},
                     **{f"{k}_max_group": int(v.max()) for k, v in w.items()}})
    print(json.dumps({"k2_calls": rows, "kernels_per_call": per_call,
                      "launches_seen": len(k2)}), flush=True)


if __name__ == "__main__":
    main()
