#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, the card's name and power
   limit) and builds the kernels of ``mxdetection_tpu_torch/csrc/`` with nvcc;
2. holds the RoIAlign kernel (K1) against its plain PyTorch version on the
   card, at the main path's shapes, in f32 (atol 1e-5) and in bf16;
3. holds the NMS kernel (K2) against its plain version on the card: an
   RPN-shaped batch (B x 5 problems, N <= 1000, IoU 0.7) and a class-aware
   batch (B problems, N = 1000, IoU 0.5); keep masks must be identical;
4. drives the main path at full width: Faster R-CNN R50-FPN COCO inference
   in bf16 (seeded random weights), ``batch_transform`` of 8 uint8 480x640
   canvases to 832x1344, ``forward_test`` and ``rcnn_postprocess``; a
   warm-up batch and 20 timed batches (median, quartiles, max). Both
   kernels' launch counts must rise; outputs must be finite with some valid
   detections; a small f32 input must give the same detections on the card
   (kernels) as on the CPU (plain);
5. prints the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a CUDA device it
exits non-zero at once: there is no CPU fallback.

``python3 chip_smoke.py --profile DIR`` also splits a batch into its stages
(CUDA events at the module boundaries) and traces two batches with
``torch.profiler``: kernel time by name, the device's idle share, and a
Chrome trace written to ``DIR/main_path_trace.json.gz``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_REPLACES = "mxdetection_tpu/ops/pallas/roi_align.py:117"
K2_REPLACES = "mxdetection_tpu/ops/pallas/nms.py:29"
MAIN_BATCH = 8
TIMED_BATCHES = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phase 1


def phase_env() -> str:
    import torch

    card = gpu_name_and_limit()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"gpu: {card}")
    from mxdetection_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip()
        .splitlines()[-1])
    path, secs, report = build.build()
    log(f"kernels built in {secs:.2f} s -> {path}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    build.load_library()
    return card


# --------------------------------------------------------------------------
# phase 2: K1


def main_path_pyramid(batch: int, dtype, gen, device):
    """P2..P5 of a 832x1344 canvas, channels-last, C=256."""
    import torch

    shapes = [(208, 336), (104, 168), (52, 84), (26, 42)]
    return [torch.randn((batch, h, w, 256), generator=gen).to(device=device, dtype=dtype)
            for h, w in shapes]


def main_path_rois(batch: int, r: int, gen, device):
    """Rois over an 800x1333 image in the 832x1344 canvas, every FPN level,
    some overhanging every edge, every 10th row invalid."""
    import torch

    cx = torch.rand((batch, r), generator=gen) * 1400 - 30
    cy = torch.rand((batch, r), generator=gen) * 880 - 30
    side = torch.exp(torch.rand((batch, r), generator=gen) * 6.0 + 2.0)  # 7 .. 3000 px
    aspect = torch.exp(torch.randn((batch, r), generator=gen) * 0.7)
    w, h = side * aspect.sqrt(), side / aspect.sqrt()
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    valid = torch.ones((batch, r), dtype=torch.bool)
    valid[:, ::10] = False
    return rois.to(device), valid.to(device)


def phase_roi_align(device) -> dict:
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    b, r, strides = MAIN_BATCH, 1000, (4, 8, 16, 32)
    rois, valid = main_path_rois(b, r, gen, device)
    levels = ra.roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    log(f"K1 rois per level: {torch.bincount(levels.flatten().long(), minlength=4).tolist()}")
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = main_path_pyramid(b, dtype, gen, device)
        kernel = lambda: roi_align_cuda(feats, rois, strides, levels, roi_valid=valid)
        plain = lambda: ra.multilevel_roi_align_plain(feats, rois, strides, levels, roi_valid=valid)
        got, ref = kernel().float(), plain().float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = err.max().item()
        if dtype == torch.float32:
            ok = max_abs <= 1e-5
            bound = "atol 1e-5"
        else:  # one bf16 rounding step: the two f32 sums may round to neighbours
            ok = bool((err <= 2.0 ** -7 * ref.abs() + 1e-5).all())
            bound = "|err| <= 2^-7 |ref| + 1e-5"
        if not torch.isfinite(got).all() or got[~valid].abs().max().item() != 0.0:
            fail(f"K1 {dtype}: non-finite output or nonzero invalid rows")
        plain_ms = time_ms(plain, reps=5)
        ms = time_ms(kernel)
        plain_ms = (plain_ms + time_ms(plain, reps=5)) / 2
        log(f"K1 roi_align {dtype}: max_abs_err {max_abs:.3e} ({bound}: "
            f"{'ok' if ok else 'FAILED'}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(B={b}, R={r}, C=256, P2-P5 of 832x1344)")
        if not ok:
            fail(f"K1 disagrees with its plain version in {dtype}")
        result[str(dtype).replace("torch.", "")] = {"max_abs_err": max_abs, "ms": ms,
                                                   "plain_ms": plain_ms}
    return result


# --------------------------------------------------------------------------
# phase 3: K2


def nms_problems(p: int, n: int, counts, gen, device, labels: bool = False):
    """Score-sorted clustered boxes (P, N, 4), valid (P, N); rows past each
    problem's count are padding. With ``labels`` the boxes are shifted by
    the class-aware coordinate offset, as class_aware_nms does."""
    import torch

    from mxdetection_tpu_torch.ops.nms import class_offsets

    centers = torch.rand((p, 60, 2), generator=gen) * torch.tensor([1333.0, 800.0])
    pick = torch.randint(0, 60, (p, n), generator=gen)
    c = torch.gather(centers, 1, pick[..., None].expand(p, n, 2))
    c = c + torch.randn((p, n, 2), generator=gen) * 12
    wh = torch.exp(torch.rand((p, n, 2), generator=gen) * 2.5 + 3.0)
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1).clamp(0, 1333)
    valid = torch.arange(n)[None, :] < torch.as_tensor(counts)[:, None]
    if labels:
        lab = torch.randint(0, 80, (p, n), generator=gen)
        boxes = boxes + lab[..., None].float() * class_offsets(boxes, valid)
    return boxes.to(device), valid.to(device)


def phase_nms(device) -> dict:
    import torch

    from mxdetection_tpu_torch.ops.cuda.nms import nms_mask_sorted_cuda
    from mxdetection_tpu_torch.ops.nms import nms_mask_sorted_plain

    gen = torch.Generator().manual_seed(2)
    b = MAIN_BATCH
    cases = [
        ("rpn", 0.7, nms_problems(b * 5, 1000, [1000, 1000, 1000, 1000, 819] * b, gen, device)),
        ("class_aware", 0.5, nms_problems(b, 1000, [1000] * b, gen, device, labels=True)),
    ]
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name, thr, (boxes, valid) in cases:
        kernel = lambda: nms_mask_sorted_cuda(boxes, valid, thr)
        plain = lambda: nms_mask_sorted_plain(boxes, valid, thr)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        mismatches = int(err.sum().item())
        plain_ms = time_ms(plain, reps=3, warmup=1)
        ms = time_ms(kernel)
        plain_ms = (plain_ms + time_ms(plain, reps=3, warmup=1)) / 2
        log(f"K2 nms {name}: {tuple(boxes.shape[:2])} problems x N, thr {thr}: "
            f"kept {int(ref.sum())}/{int(valid.sum())}, mismatched keep bits {mismatches}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if mismatches:
            fail(f"K2 keep mask differs from its plain version ({name})")
        result[name] = {"ms": ms, "plain_ms": plain_ms}
        result["max_abs_err"] = max(result["max_abs_err"], err.max().item())
        result["ms"] += ms
        result["plain_ms"] += plain_ms
    return result


# --------------------------------------------------------------------------
# phase 4: main path


def detect(model, cfg, raw, hw, dtype):
    import torch

    from mxdetection_tpu_torch.data.transforms import batch_transform
    from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_postprocess

    d = cfg.data
    pad_hw = (d.pad_h, d.pad_w)
    b = raw.shape[0]
    flip = torch.zeros((b,), dtype=torch.bool, device=raw.device)
    gtb = torch.zeros((b, d.max_gt, 4), device=raw.device)
    with torch.no_grad():
        tb = batch_transform(raw, hw, flip, gtb, out_hw=pad_hw, scale_size=d.scale,
                             max_size=d.max_size, mean=d.mean, std=d.std, dtype=dtype)
        out = model.forward_test(tb["images"], tb["im_info"])
        return rcnn_postprocess(out, cfg, pad_hw, tb["im_info"]), out


def check_dets(dets, hw, what: str) -> int:
    import torch

    v = dets["valid"]
    n_valid = int(v.sum().item())
    if not (torch.isfinite(dets["boxes"]).all() and torch.isfinite(dets["scores"]).all()):
        fail(f"{what}: non-finite detections")
    if n_valid == 0:
        fail(f"{what}: no valid detections")
    bx = dets["boxes"][v]
    lim = hw[:, None, :].expand(*v.shape, 2)[v]
    if (bx < 0).any() or (bx[:, 2] > lim[:, 1]).any() or (bx[:, 3] > lim[:, 0]).any():
        fail(f"{what}: detections outside the image")
    if ((dets["labels"][v] < 0) | (dets["labels"][v] >= 80)).any():
        fail(f"{what}: labels out of range")
    return n_valid


def small_parity(device) -> None:
    """A 256x320 f32 input through the port on the card (kernels) and on the
    CPU (plain versions, which the CPU tests hold against the JAX package)."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("configs/faster_rcnn_r50_fpn_1x.py").override(**{
        "data.pad_h": 256, "data.pad_w": 320, "data.scale": 240, "data.max_size": 320,
        "backbone.dtype": "float32", "test.max_per_image": 20,
        "rpn.pre_nms_top_n_test": 400, "rpn.post_nms_top_n_test": 100,
        "test.pre_nms_per_class": 200})
    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (2, 240, 300, 3), generator=gen, dtype=torch.uint8)
    hw = torch.tensor([[240.0, 300.0], [200.0, 300.0]])
    dets = {}
    for dev in ("cpu", device):
        model = build_detector(cfg, device="cpu", seed=0).to(dev)
        dets[dev] = detect(model, cfg, raw.to(dev), hw.to(dev), torch.float32)[0]
    cpu, gpu = dets["cpu"], {k: v.cpu() for k, v in dets[device].items()}
    n = check_dets(gpu, hw, "small f32 input on the card")
    same_valid = torch.equal(cpu["valid"], gpu["valid"])
    box_err = (cpu["boxes"] - gpu["boxes"]).abs().max().item()
    score_err = (cpu["scores"] - gpu["scores"]).abs().max().item()
    same_labels = torch.equal(cpu["labels"], gpu["labels"])
    log(f"small f32 parity card vs CPU: {n} valid, same valid {same_valid}, same labels "
        f"{same_labels}, max box err {box_err:.3e}, max score err {score_err:.3e} "
        "(bound 1e-2 px, 1e-4)")
    if not (same_valid and same_labels and box_err <= 1e-2 and score_err <= 1e-4):
        fail("small f32 input: card detections differ from the CPU port's")


def phase_main_path(device, card: str, counters, profile_dir: str | None) -> dict:
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector

    small_parity(device)

    cfg = load_config("configs/faster_rcnn_r50_fpn_1x.py")
    dtype = getattr(torch, cfg.backbone.dtype)
    t0 = time.perf_counter()
    model = build_detector(cfg, device=device, seed=0)
    log(f"main path: {cfg.name}, {cfg.backbone.dtype}, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(4)
    raw = torch.randint(0, 256, (MAIN_BATCH, 480, 640, 3), generator=gen,
                        dtype=torch.uint8).to(device)
    hw = torch.tensor([[480.0, 640.0]] * MAIN_BATCH, device=device)

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets, out = detect(model, cfg, raw, hw, dtype)  # warm-up
    torch.cuda.synchronize()
    log(f"main path warm-up batch: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    times = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        dets, out = detect(model, cfg, raw, hw, dtype)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {c.name: c.n for c in counters}
    n_valid = check_dets({k: v.cpu() for k, v in dets.items()}, hw.cpu(), "main path")
    for name, n in launches.items():
        if n == 0:
            fail(f"main path never launched the {name} kernel")
    log(f"main path ms per batch ({card}): " + ", ".join(f"{ms:.2f}" for ms in times))
    q = torch.tensor(times).quantile(torch.tensor([0.25, 0.5, 0.75])).tolist()
    log(f"main path: {TIMED_BATCHES} batches of {MAIN_BATCH}x832x1344 bf16, ms per batch: "
        f"p25 {q[0]:.2f}, median {q[1]:.2f}, p75 {q[2]:.2f}, max {max(times):.2f}; "
        f"median {MAIN_BATCH * 1e3 / q[1]:.1f} images/s ({card})")
    log(f"main path: {int(out['roi_valid'].sum())}/{out['roi_valid'].numel()} valid proposals, "
        f"pyramid max |P| {max(p.abs().max().item() for p in out['pyramid']):.1f}, "
        f"{n_valid} valid detections in the last batch; launches {launches}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile_dir is not None:
        phase_profile(model, cfg, raw, hw, dtype, profile_dir)
    return launches


# --------------------------------------------------------------------------
# optional phase 5 (--profile DIR): where the main path's time goes


def stage_breakdown(model, cfg, raw, hw, dtype, reps: int) -> dict:
    """Mean device-timeline ms of each stage of a main-path batch, split at
    the module boundaries by CUDA events recorded from forward hooks. A
    stage's time includes any device idle time inside it."""
    import torch

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    hooks = [
        model.backbone.register_forward_pre_hook(lambda *_: mark("batch_transform")),
        model.backbone.register_forward_hook(lambda *_: mark("backbone")),
        model.fpn.register_forward_hook(lambda *_: mark("fpn")),
        model.rpn.register_forward_hook(lambda *_: mark("rpn_head")),
        model.bbox_head0.register_forward_pre_hook(lambda *_: mark("proposals + roi_align")),
        model.bbox_head0.register_forward_hook(lambda *_: mark("bbox_head")),
    ]
    totals = {}
    try:
        for _ in range(reps):
            marks.clear()
            mark("start")
            detect(model, cfg, raw, hw, dtype)
            mark("rcnn_postprocess")
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(marks, marks[1:]):
                totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / reps
    finally:
        for h in hooks:
            h.remove()
    return totals


def phase_profile(model, cfg, raw, hw, dtype, out_dir: str) -> None:
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = stage_breakdown(model, cfg, raw, hw, dtype, reps=5)
    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"profile stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")

    batches = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            detect(model, cfg, raw, hw, dtype)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {batches} batches under torch.profiler: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernel names")
    for e in kernels[:20]:
        ms = e.self_device_time_total / 1e3 / batches
        log(f"profile kernel {ms:8.3f} ms/batch {e.count // batches:6d} calls/batch  {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "main_path_trace.json.gz")
    prof.export_chrome_trace(path)
    log(f"profile: trace written to {path}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="after the checks, split a batch into its stages and trace "
                             "it with torch.profiler into DIR")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU fallback")
    try:
        import mxdetection_tpu_torch  # noqa: F401
    except ImportError:
        fail("mxdetection_tpu_torch not importable: run from the root of the repository")
    device = "cuda"

    card = phase_env()
    k1 = phase_roi_align(device)
    k2 = phase_nms(device)

    from mxdetection_tpu_torch.ops.cuda import nms as nms_cuda
    from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda

    launches = phase_main_path(device, card, [roi_cuda.launch_count, nms_cuda.launch_count],
                               args.profile)
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda",
         "source": "mxdetection_tpu_torch/csrc/roi_align.cu", "replaces": K1_REPLACES,
         "launches": launches["roi_align"], "max_abs_err": k1["float32"]["max_abs_err"],
         "ms": k1["bfloat16"]["ms"], "plain_ms": k1["bfloat16"]["plain_ms"]},
        {"name": "nms_mask_sorted", "route": "cuda",
         "source": "mxdetection_tpu_torch/csrc/nms.cu", "replaces": K2_REPLACES,
         "launches": launches["nms"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
