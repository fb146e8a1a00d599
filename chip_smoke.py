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
   It also holds K2 at the training path's shapes (40 problems x 2000
   boxes, IoU 0.7);
4. holds the IoU kernel (K4) against its plain version at the RPN
   assigner's shapes (8 x 279,279 anchors x 100 gt): max error must be 0;
5. holds the RoIAlign backward (K3) and its f32 -> bf16 convert (K3b)
   against torch autograd of K1's plain version at training shapes (8 x 512
   rois over P2-P5 of 832x1344, C 256): f32 within 1e-5 of the largest
   gradient, bf16 within one bf16 rounding of the f32 result;
6. drives the inference path at full width: Faster R-CNN R50-FPN COCO
   inference in bf16 (seeded random weights), ``batch_transform`` of 8
   uint8 480x640 canvases to 832x1344, ``forward_test`` and
   ``rcnn_postprocess``; a warm-up batch and 20 timed batches (median,
   quartiles, max). K1's and K2's launch counts must rise; outputs must be
   finite with some valid detections; a small f32 input must give the same
   detections on the card (kernels) as on the CPU (plain);
7. drives the training path at full width: ``Trainer.run_step`` of the
   same config (f32 master weights, bf16 compute) on 8 uint8 480x640
   canvases with about 7 gt boxes each; 2 warm-up steps and 10 timed steps
   (median ms per step, images/s, peak memory). Loss and grad norm must be
   finite and the launch counts of K1, K2, K3, K3b and K4 must rise; a
   small f32 step (256x320, batch 2, the same weights and random draws on
   both) must give the same losses, grad norms and discrete metrics on the
   card as on the CPU;
8. prints the card's name and power limit, the kernel table as one JSON
   line, then, as the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a CUDA device it
exits non-zero at once: there is no CPU fallback.

``python3 chip_smoke.py --profile DIR`` also splits an inference batch and a
training step into their stages (CUDA events at the module boundaries) and
traces each with ``torch.profiler``: kernel time by name, the device's idle
share, and Chrome traces written to ``DIR/main_path_trace.json.gz`` and
``DIR/train_step_trace.json.gz``.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work on this run's inputs: the larger of the bytes the function must
move (each input read once, each output written once) over 3.35 TB/s and
its operations over 67 TFLOP/s (f32 outside the tensor cores), the H100
SXM's published peaks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_REPLACES = "mxdetection_tpu/ops/pallas/roi_align.py:117"
K2_REPLACES = "mxdetection_tpu/ops/pallas/nms.py:29"
K3_REPLACES = "mxdetection_tpu/ops/pallas/roi_align.py:424"
K3B_REPLACES = "mxdetection_tpu/ops/pallas/roi_align.py:516"
K4_REPLACES = "mxdetection_tpu/ops/pallas/iou.py:24"
MAIN_BATCH = 8
TIMED_BATCHES = 20
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_ROIS = 512        # bbox_head.num_samples
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of work moving ``nbytes`` and
    doing ``flops`` f32 operations on the card's published peaks."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def touched_pixels(shapes, rois, strides, levels, valid) -> int:
    """Pixels of the pyramid that RoIAlign reads with a nonzero weight for
    these rois: where the gradient of the plain version, on one channel of
    ones, is nonzero."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra

    b = rois.shape[0]
    ones = [torch.ones((b, h, w, 1), device=rois.device, requires_grad=True) for h, w in shapes]
    out = ra.multilevel_roi_align_plain(ones, rois, strides, levels, roi_valid=valid)
    return sum(int((g != 0).sum()) for g in torch.autograd.grad(out.sum(), ones))


def roi_flops(n_valid: int, p: int, s: int, c: int) -> float:
    """Four taps of a bilinear sample, a multiply and an add each."""
    return float(n_valid) * p * p * s * s * c * 8


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
    shapes = [(208, 336), (104, 168), (52, 84), (26, 42)]
    pixels = touched_pixels(shapes, rois, strides, levels, valid)
    n_valid = int(valid.sum())
    # bf16: touched pixels read, output written, rois/levels/valid read
    nbytes = (pixels * 256 * 2 + b * r * 49 * 256 * 2 + b * r * (16 + 4 + 1))
    bound_ms, bound_by = bound(nbytes, roi_flops(n_valid, 7, 2, 256))
    log(f"K1 bound (bf16): {pixels} pyramid pixels touched, {nbytes / 1e6:.1f} MB moved, "
        f"{bound_ms:.4f} ms, bound by {bound_by}")
    result = {"bound_ms": bound_ms, "bound_by": bound_by}
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
            rule = "atol 1e-5"
        else:  # one bf16 rounding step: the two f32 sums may round to neighbours
            ok = bool((err <= 2.0 ** -7 * ref.abs() + 1e-5).all())
            rule = "|err| <= 2^-7 |ref| + 1e-5"
        if not torch.isfinite(got).all() or got[~valid].abs().max().item() != 0.0:
            fail(f"K1 {dtype}: non-finite output or nonzero invalid rows")
        plain_ms = time_ms(plain, reps=5)
        ms = time_ms(kernel)
        plain_ms = (plain_ms + time_ms(plain, reps=5)) / 2
        log(f"K1 roi_align {dtype}: max_abs_err {max_abs:.3e} ({rule}: "
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
        # the training proposals: pre_nms_top_n_train 2000 per level; P6 of
        # 832x1344 has 819 anchors
        ("rpn_train", 0.7, nms_problems(b * 5, 2000, [2000, 2000, 2000, 2000, 819] * b, gen,
                                        device)),
    ]
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
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
        p, n = boxes.shape[:2]
        # boxes and valid read, keep written; an IoU test (~14 f32 ops) per
        # pair of the upper triangle
        bound_ms, bound_by = bound(p * n * (16 + 1 + 1), p * n * (n - 1) / 2 * 14)
        log(f"K2 nms {name}: {(p, n)} problems x N, thr {thr}: "
            f"kept {int(ref.sum())}/{int(valid.sum())}, mismatched keep bits {mismatches}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if mismatches:
            fail(f"K2 keep mask differs from its plain version ({name})")
        result[name] = {"ms": ms, "plain_ms": plain_ms}
        result["max_abs_err"] = max(result["max_abs_err"], err.max().item())
        result["ms"] += ms
        result["plain_ms"] += plain_ms
        result["bound_ms"] += bound_ms
        result["bound_by"] = bound_by
    return result


# --------------------------------------------------------------------------
# phase 4: K4


def phase_iou(device) -> dict:
    """K4 at the RPN assigner's shapes: the anchors of the 832x1344 canvas
    (279,279) against 100 padded gt boxes per image, batch 8."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.detectors.rcnn import rpn_level_anchors
    from mxdetection_tpu_torch.ops.boxes import pairwise_iou
    from mxdetection_tpu_torch.ops.cuda.iou import pairwise_iou_cuda

    cfg = load_config("faster_rcnn_r50_fpn_1x")
    anchors = torch.cat(rpn_level_anchors(cfg, (832, 1344), device=device), 0)
    b, n, g = MAIN_BATCH, anchors.shape[0], 100
    gen = torch.Generator().manual_seed(5)
    xy = torch.rand((b, g, 2), generator=gen) * torch.tensor([1300.0, 780.0])
    wh = torch.exp(torch.rand((b, g, 2), generator=gen) * 4.0 + 2.0)  # 7 .. 400 px
    gt = torch.cat([xy, xy + wh], -1)
    gt[:, ::10] = 0.0  # padding rows
    gt = gt.to(device)
    boxes1 = anchors.expand(b, n, 4)
    kernel = lambda: pairwise_iou_cuda(boxes1, gt)
    plain = lambda: pairwise_iou(boxes1, gt)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    max_abs = (got - ref).abs().max().item()
    exact = torch.equal(got, ref)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    ms = time_ms(kernel)
    plain_ms = (plain_ms + time_ms(plain, reps=3, warmup=1)) / 2
    bound_ms, bound_by = bound(n * 16 + b * g * 16 + b * n * g * 4, b * n * g * 14)
    log(f"K4 iou: ({b}, {n}, {g}), {int((ref > 0.5).sum())} pairs above 0.5, max_abs_err "
        f"{max_abs:.3e} (must be 0, bit-identical: {exact}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not exact:
        fail("K4 differs from its plain version")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# --------------------------------------------------------------------------
# phase 5: K3 + K3b


def phase_roi_align_bwd(device) -> dict:
    """K3 (+ K3b) at training shapes against torch autograd of K1's plain
    version, on the same rois, levels and upstream gradient."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import f32_to_bf16_cuda, roi_align_bwd_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    b, r, strides = MAIN_BATCH, TRAIN_ROIS, (4, 8, 16, 32)
    rois, valid = main_path_rois(b, r, gen, device)
    levels = ra.roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    feats = main_path_pyramid(b, torch.float32, gen, device)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    g16 = torch.randn((b, r, 7, 7, 256), generator=gen).to(device=device, dtype=torch.bfloat16)
    g32 = g16.float()

    leaves = [f.requires_grad_() for f in feats]
    out = ra.multilevel_roi_align_plain(leaves, rois, strides, levels, roi_valid=valid)
    plain = lambda: torch.autograd.grad(out, leaves, g32, retain_graph=True)
    ref = torch.cat([x.flatten() for x in plain()])
    scale = ref.abs().max().item()
    result = {}
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        kernel = lambda: roi_align_bwd_cuda(g, shapes, rois, strides, levels, roi_valid=valid,
                                            out_dtype=dtype)
        got = torch.cat([x.float().flatten() for x in kernel()])
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = err.max().item()
        if dtype == torch.float32:
            ok = max_abs <= 1e-5 * scale
            rule = "max|err| <= 1e-5 max|ref| (atomics reorder the sums)"
        else:  # one bf16 rounding of the f32 sum, which itself reorders
            ok = bool((err <= 2.0 ** -8 * ref.abs() + 1e-5 * scale).all())
            rule = "|err| <= 2^-8 |ref| + 1e-5 max|ref|"
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        log(f"K3 roi_align_bwd {dtype}: max_abs_err {max_abs:.3e} of max|ref| {scale:.3e} "
            f"({rule}: {'ok' if ok else 'FAILED'}); kernel (zero + K3"
            f"{' + K3b' if dtype == torch.bfloat16 else ''}) {ms:.4f} ms, autograd of plain "
            f"{plain_ms:.4f} ms (B={b}, R={r}, C=256, P2-P5 of 832x1344)")
        if not ok:
            fail(f"K3 disagrees with autograd of the plain RoIAlign in {dtype}")
        result[str(dtype).replace("torch.", "")] = {"max_abs_err": max_abs, "ms": ms,
                                                   "plain_ms": plain_ms}
    n_valid = int(valid.sum())
    pixels = sum(h * w for h, w in shapes) * b
    # bf16: g of the valid rois read, every level gradient written once
    k3_bytes = n_valid * 49 * 256 * 2 + pixels * 256 * 2 + b * r * (16 + 4 + 1)
    result["bound_ms"], result["bound_by"] = bound(k3_bytes, roi_flops(n_valid, 7, 2, 256))

    acc = torch.randn(pixels * 256, generator=gen).to(device)
    kernel = lambda: f32_to_bf16_cuda(acc)
    library = lambda: acc.to(torch.bfloat16)
    exact = torch.equal(kernel(), library())
    max_abs = (kernel().float() - library().float()).abs().max().item()
    k3b = {"max_abs_err": max_abs, "ms": time_ms(kernel), "library_ms": time_ms(library)}
    k3b["plain_ms"] = k3b["library_ms"]  # the plain version is that one PyTorch call
    k3b["bound_ms"], k3b["bound_by"] = bound(acc.numel() * 6, acc.numel())
    log(f"K3b f32_to_bf16: {acc.numel()} values, identical to .to(bfloat16): {exact}; kernel "
        f"{k3b['ms']:.4f} ms, .to(bfloat16) {k3b['library_ms']:.4f} ms, bound "
        f"{k3b['bound_ms']:.4f} ms ({k3b['bound_by']}); K3 bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}) for {n_valid} valid rois")
    if not exact:
        fail("K3b differs from .to(torch.bfloat16)")
    result["k3b"] = k3b
    return result


# --------------------------------------------------------------------------
# phase 6: inference path


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


def trace(run, reps: int, label: str, path: str) -> None:
    """``reps`` calls of ``run`` under torch.profiler: device busy time, idle
    share, the 20 costliest kernels a call, and a Chrome trace at ``path``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {label}: {reps} under torch.profiler: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernel names")
    for e in kernels[:20]:
        ms = e.self_device_time_total / 1e3 / reps
        log(f"profile {label} kernel {ms:8.3f} ms {e.count // reps:6d} calls  {e.key[:90]}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    log(f"profile {label}: trace written to {path}")


def phase_profile(model, cfg, raw, hw, dtype, out_dir: str) -> None:
    import os

    stages = stage_breakdown(model, cfg, raw, hw, dtype, reps=5)
    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"profile stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
    trace(lambda: detect(model, cfg, raw, hw, dtype), 2, "batch",
          os.path.join(out_dir, "main_path_trace.json.gz"))


# --------------------------------------------------------------------------
# phase 7: training path


def train_batch(b: int, raw_hw, gen, device) -> dict:
    """``b`` uint8 canvases with 3 to 11 gt boxes each (the COCO mean is
    about 7), padded to 100 rows, half of the images flipped."""
    import torch

    h, w = raw_hw
    n_gt = torch.randint(3, 12, (b,), generator=gen)
    xy = torch.rand((b, 100, 2), generator=gen) * torch.tensor([w * 0.8, h * 0.8])
    wh = torch.exp(torch.rand((b, 100, 2), generator=gen) * 3.0 + 2.7)  # 15 .. 300 px
    boxes = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w - 1.0, h - 1.0]))], -1)
    valid = torch.arange(100)[None, :] < n_gt[:, None]
    batch = {
        "raw": torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8),
        "hw": torch.tensor([[float(h), float(w)]] * b),
        "flip": torch.rand((b,), generator=gen) < 0.5,
        "gt_boxes": torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
        "gt_labels": torch.randint(0, 80, (b, 100), generator=gen) * valid,
        "gt_valid": valid,
    }
    return {k: v.to(device) for k, v in batch.items()}


class ReplayDraws:
    """Random draws made once on the CPU and handed to either device, so a
    step on the card and one on the CPU sample the same boxes."""

    def __init__(self, seed: int):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.cache = {}

    def on(self, device):
        import torch

        def draws(name, shape):
            if name not in self.cache:
                self.cache[name] = torch.rand(shape, generator=self.gen)
            return self.cache[name].to(device)
        return draws


def grad_norms(model) -> dict:
    import torch

    out = {}
    for mod in ("backbone", "fpn", "rpn", "bbox_head0"):
        gs = [p.grad.double() for p in getattr(model, mod).parameters() if p.grad is not None]
        out[f"gnorm_{mod}"] = float(torch.sqrt(sum((g * g).sum() for g in gs)))
    return out


def small_train_parity(device) -> None:
    """One f32 training step at 256x320, batch 2, on the card (kernels) and
    on the CPU (plain versions, which the CPU tests hold against the JAX
    package), from the same weights and the same random draws."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector
    from mxdetection_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("faster_rcnn_r50_fpn_1x", {
        "data.pad_h": 256, "data.pad_w": 320, "data.scale": 240, "data.max_size": 320,
        "data.max_gt": 8, "backbone.dtype": "float32", "bbox_head.num_samples": 32,
        "rpn.pre_nms_top_n_train": 400, "rpn.post_nms_top_n_train": 100})
    batch = train_batch(2, (240, 300), torch.Generator().manual_seed(7), "cpu")
    batch = {k: v[:, :8] if k.startswith("gt_") else v for k, v in batch.items()}
    replay = ReplayDraws(8)
    model = build_detector(cfg, device="cpu", seed=0, train=True)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for dev in ("cpu", device):
        m = build_detector(cfg, device="cpu", train=True)
        m.load_state_dict(state)
        metrics = Trainer(cfg, m, device=dev).run_step(batch, draws=replay.on(dev))
        res[dev] = {**{k: float(v) for k, v in metrics.items()}, **grad_norms(m)}
    cpu, gpu = res["cpu"], res[device]
    worst = {}
    for k, r in cpu.items():
        if k in ("num_pos_rois", "rcnn_acc0"):
            if gpu[k] != r:
                fail(f"small train step: {k} {gpu[k]} on the card, {r} on the CPU")
            continue
        worst[k] = abs(gpu[k] - r) / max(abs(r), 1e-12)
    log("small f32 train step card vs CPU: " + ", ".join(
        f"{k} {cpu[k]:.6g} rel {worst[k]:.2e}" for k in sorted(worst))
        + f"; num_pos_rois {cpu['num_pos_rois']}, rcnn_acc0 {cpu['rcnn_acc0']:.4f} equal"
        " (bounds: losses 1e-4, grad norms 1e-3 relative)")
    for k, rel in worst.items():
        if rel > (1e-3 if "norm" in k else 1e-4):
            fail(f"small train step: {k} differs by {rel:.2e} relative between card and CPU")


def train_stage_breakdown(trainer, batch, reps: int) -> dict:
    """Mean device-timeline ms of each stage of a training step (the calls
    of ``Trainer.run_step``, split at the module boundaries by CUDA events)."""
    import torch

    from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_loss

    model, marks = trainer.model, []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    hooks = [
        model.backbone.register_forward_hook(lambda *_: mark("backbone")),
        model.fpn.register_forward_hook(lambda *_: mark("fpn")),
        model.rpn.register_forward_hook(lambda *_: mark("rpn_head")),
        model.bbox_head0.register_forward_pre_hook(
            lambda *_: mark("proposals + sample_rois + roi_align")),
        model.bbox_head0.register_forward_hook(lambda *_: mark("bbox_head")),
    ]
    totals = {}
    try:
        for _ in range(reps):
            marks.clear()
            mark("start")
            tb = trainer.device_batch(batch)
            mark("batch_transform")
            for p in trainer.params:
                p.grad = None
            out = model.forward_train(tb, trainer.draws)
            mark("targets")
            loss, _ = rcnn_loss(out, tb, trainer.draws, trainer.cfg)
            mark("rcnn_loss (anchor assign)")
            loss.backward()
            mark("backward")
            trainer.optimizer.step([p.grad for p in trainer.params])
            mark("optimizer")
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(marks, marks[1:]):
                totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / reps
    finally:
        for h in hooks:
            h.remove()
    return totals


def phase_train_path(device, card: str, counters, profile_dir: str | None) -> dict:
    import os

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.train.trainer import Trainer

    small_train_parity(device)
    cfg = load_config("faster_rcnn_r50_fpn_1x", {"data.batch_size_per_device": MAIN_BATCH})
    t0 = time.perf_counter()
    # steps per epoch of COCO train2017 (117,266 images with annotations)
    trainer = Trainer(cfg, device=device, seed=0, steps_per_epoch=117266 // MAIN_BATCH)
    log(f"train path: {cfg.name}, f32 master weights, {cfg.backbone.dtype} compute, seeded "
        f"init in {time.perf_counter() - t0:.1f} s")
    batch = train_batch(MAIN_BATCH, (480, 640), torch.Generator().manual_seed(9), device)
    log(f"train path: {int(batch['gt_valid'].sum())} gt boxes in the batch of {MAIN_BATCH}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        t0 = time.perf_counter()
        m = trainer.run_step(batch)
        torch.cuda.synchronize()
        log(f"train path warm-up step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"loss {float(m['loss']):.4f}")
    for c in counters:
        c.reset()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = trainer.run_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = {c.name: c.n for c in counters}
    for name, n in launches.items():
        if n == 0:
            fail(f"training path never launched the {name} kernel")
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        fail(f"training path: loss {float(m['loss'])}, grad norm {float(m['grad_norm'])}")
    q = torch.tensor(times).quantile(torch.tensor([0.25, 0.5, 0.75])).tolist()
    log(f"train path ms per step ({card}): " + ", ".join(f"{ms:.2f}" for ms in times))
    log(f"train path: {TRAIN_STEPS} steps of {MAIN_BATCH}x832x1344 bf16, ms per step: "
        f"p25 {q[0]:.2f}, median {q[1]:.2f}, p75 {q[2]:.2f}, max {max(times):.2f}; "
        f"median {MAIN_BATCH * 1e3 / q[1]:.1f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    log(f"train path: losses {', '.join(f'{x:.4f}' for x in losses)}; last step "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(m.items()))
        + f"; launches per step {({k: n / TRAIN_STEPS for k, n in launches.items()})}")
    if profile_dir is not None:
        stages = train_stage_breakdown(trainer, batch, reps=3)
        total = sum(stages.values())
        for name, ms in stages.items():
            log(f"profile train stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
        trace(lambda: trainer.run_step(batch), 2, "train step",
              os.path.join(profile_dir, "train_step_trace.json.gz"))
    return launches


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
    k4 = phase_iou(device)
    k3 = phase_roi_align_bwd(device)

    from mxdetection_tpu_torch.ops.cuda import iou as iou_cuda
    from mxdetection_tpu_torch.ops.cuda import nms as nms_cuda
    from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda

    paths = {
        "inference": phase_main_path(device, card, [roi_cuda.launch_count,
                                                    nms_cuda.launch_count], args.profile),
        "train": phase_train_path(device, card, [
            roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
            roi_cuda.convert_launch_count, iou_cuda.launch_count], args.profile),
    }

    def entry(name, source, replaces, counter, res, dtype_res=None):
        timed = res if dtype_res is None else dtype_res
        by_path = {path: n[counter] for path, n in paths.items() if counter in n}
        return {"name": name, "route": "cuda", "source": f"mxdetection_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": res["max_abs_err"],
                "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res.get("library_ms")}

    k1_err = {**k1, "max_abs_err": k1["float32"]["max_abs_err"]}
    k3_err = {**k3, "max_abs_err": k3["float32"]["max_abs_err"]}
    kernels = [
        entry("roi_align_fwd", "roi_align.cu", K1_REPLACES, "roi_align", k1_err, k1["bfloat16"]),
        entry("nms_mask_sorted", "nms.cu", K2_REPLACES, "nms", k2),
        entry("roi_align_bwd", "roi_align_bwd.cu", K3_REPLACES, "roi_align_bwd", k3_err,
              k3["bfloat16"]),
        entry("f32_to_bf16", "roi_align_bwd.cu", K3B_REPLACES, "f32_to_bf16", k3["k3b"]),
        entry("pairwise_iou", "iou.cu", K4_REPLACES, "iou", k4),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
