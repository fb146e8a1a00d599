#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, the card's name and power
   limit) and builds the kernels of ``mxdetection_tpu_torch/csrc/`` with nvcc;
2. holds the RoIAlign kernel (K1: a warp a bin row, a lane 16 bytes of
   channels) against its plain PyTorch version on the card, at the main
   path's shapes, in f32 (atol 1e-5) and in bf16, and at C = 131 (the
   lanes' channel-by-channel loads) in both; logs its ptxas lines (failing on
   spills) and the bytes its taps gather beside the bytes bound and the L2
   copy rate; with ``--baseline DIR``, the largest difference from DIR's
   kernel;
3. holds the NMS kernel (K2: the mask's upper tiles, then a block per
   problem sweeping 64 rows a step) against its plain version on the card:
   an RPN-shaped batch (B x 5 problems, N <= 1000, IoU 0.7), a class-aware
   batch (B problems, N = 1000, IoU 0.5) and the training path's shapes
   (40 problems x 2000 boxes, IoU 0.7), timed, and awkward problems (ragged
   N, N = 2100 and 5000 with invalid rows among the valid ones, a problem
   with no valid row, NaN, zero-area and duplicated boxes, one box that
   suppresses every later row, IoUs exactly at the threshold), and R-FCN's
   RPN shape (8 problems of N = 6000, IoU 0.7, timed apart); keep masks
   must be identical; logs ptxas's lines (failing on spills) and the
   sweep's SASS atomics and warp reductions; after step 9, the same check
   and times on the problems the first Faster R-CNN inference batch and
   the first training step handed K2, with the share of rows kept and of
   tested pairs that do not intersect;
4. holds the max-IoU assigner (K4: pass A, each row's max IoU and first
   argmax or each gt's best, and pass B, the low-quality force and the
   labels; the IoU matrix never reaches memory) bit for bit against the
   dense plain assigner at the RPN shape (8 x 279,279 anchors x 100 gt with
   padded rows, duplicated gt, two gt sharing their best anchor, an image
   without gt and the inside mask; with the force and without), and pass A
   at ``sample_rois``' and ``relabel_rois``' shapes; the route's peak memory
   must stay under a byte a (box, gt) pair; then the route at RetinaNet's
   assignment (8 x 209,538 anchors of P3-P7 x 100 gt, the force on, no
   inside mask) bit for bit and timed; logs its ptxas lines (failing on
   spills);
5. holds the RoIAlign backward (K3: a block owns an output tile and sums
   the terms of the rois that touch it; K3b, the bf16 convert, is its
   epilogue) against torch autograd of K1's plain version at training
   shapes (8 x 512 rois over P2-P5 of 832x1344, C 256): f32 within 1e-5 of
   the largest gradient, two runs (and a run from the same g in bf16)
   bit-identical, the bf16 gradient equal to the f32 one rounded; against
   its plain model ``roi_align_bwd_tiles`` bit for bit on ragged maps and
   channel counts with rois of every awkward kind; logs ptxas's lines
   (failing on spills), the tile and chunk of the built kernel (failing
   where they are not the model's) and the (roi, tile) pairs and longest
   roi list; after step 9, the same checks and a time on the rois of the
   training path's first step (with a seeded upstream gradient), and K1's
   check and time on those rois;
6. drives the inference path at full width: Faster R-CNN R50-FPN COCO
   inference in bf16 (seeded random weights), ``batch_transform`` of 8
   uint8 480x640 canvases to 832x1344, ``forward_test`` and
   ``rcnn_postprocess``; a warm-up batch and 20 timed batches (median,
   quartiles, max). K1's and K2's launch counts must rise; outputs must be
   finite with some valid detections; a small f32 input must give the same
   detections on the card (kernels) as on the CPU (plain);
7. holds the deformable-conv kernel (K5 at stride 1, K5b at stride 2)
   against its plain version at the six DCN layer shapes of Cascade
   R101-DCN at 8x832x1344 (offsets of std 1.5 cells): f32 within 1e-4 of
   the largest output, bf16 within two bf16 roundings; also with
   ``radius=3``, at dilation 2, and with zero offsets against ``F.conv2d``
   (f32, and bf16 at the stage-3 and stage-4 shapes), on a ragged bf16 M at
   both strides, and the card's weight tiles bit for bit against
   ``wgmma_weight_tiles``; logs ptxas's registers and spills of the bf16
   kernel, its shared memory and the ``HGMMA`` count in its SASS (failing on
   spills or none); times the kernel, its plain version and cuDNN's
   ``F.conv2d`` of the same shape (which computes the same function only at
   zero offsets);
8. drives the Cascade R-CNN R101-DCN inference path at full width (bf16,
   seeded weights, every offset conv overwritten by seeded noise scaled so
   the offsets have a std of about 1 cell); a warm-up batch and 20 timed
   batches as in 6, with the launch counts of K1, K2, K5 and K5b rising and
   a card-vs-CPU check on a small f32 input;
9. drives the training path at full width: ``Trainer.run_step`` of the
   same config (f32 master weights, bf16 compute) on 8 uint8 480x640
   canvases with about 7 gt boxes each; 2 warm-up steps and 10 timed steps
   (median ms per step, images/s, peak memory). Loss and grad norm must be
   finite and the launch counts of K1, K2, K3 (bf16 too: K3b) and K4 (both
   passes) must rise; a
   small f32 step (256x320, batch 2, the same weights and random draws on
   both) must give the same losses, grad norms and discrete metrics on the
   card as on the CPU;
10. holds the deformable conv's backward kernels (K6/K6b: the fused weight
   gradient, dW = patches^T g on the tensor cores from patch tiles built in
   shared memory, with the offset gradient reduced over channels; K7/K7b:
   dx, the terms of an output tile's taps sorted by input cell in shared
   memory, each cell summed in registers and added with a vector atomic)
   against their plain versions at the six DCN layer shapes (offsets of
   std 1.5 cells): f32 dW, doffsets and dx within 1e-4 of the largest
   value, K6 and K7 on the bf16 inputs of the main path as well, and the
   whole bf16 backward of ``DeformConvFunction`` against the f32 plain one,
   norm-relative under 3 % (dx, dW) and 6 % (doffsets); also with
   ``radius=3``, on a ragged M, at zero offsets against ``F.conv2d``'s
   gradients (f32) and cuDNN's wgrad (bf16 values), and K7 on f32 and bf16
   dpatch with offsets of std 6 cells and some at +-40 (corners spilled out
   of the windows and off the map, timed beside the spill share) and at
   dilation 2; logs ptxas's lines of K6 and K7 (failing on spills), K6's
   ``HGMMA`` count (failing on none), the partition and the window the
   built kernels report (failing where they are not the plain models'),
   K7's SASS atomics, and the peak memory of the whole DCN backward at the
   stage-3 shape; times each kernel, its plain version and cuDNN's conv
   backward of the same shape (wgrad beside K6, dgrad beside K7), the dW
   matmul that K6 replaced, and K7 also on offsets of std 1 cell, about
   the main path's;
11. drives the Cascade R-CNN R101-DCN training path at full width:
   ``Trainer.run_step`` in bf16 with seeded weights and the offset-conv
   noise of step 8, 2 warm-up and 10 timed steps, every kernel's launch count
   rising (K5, K5b, K6, K6b, K7, K7b 27 or 3 times a step), after a
   card-vs-CPU f32 step at 256x320 with that noise in the first DCN of each
   stage (losses 1e-4, grad norms 1e-3, discrete metrics equal);
12. drives the SyncBN data-parallel training path: the
   ``multihost_dp_faster_rcnn_v5p16`` config (SyncBN at every backbone norm,
   every stage training) through ``Trainer.run_step`` in a NCCL process group
   of world size 1 (a TCP rendezvous on 127.0.0.1): a small f32 step on the
   card against the CPU as in 9, the same step with ``backbone.remat``
   (losses and grad norms within 1e-5 relative, running statistics the same);
   at 8x832x1344 in bf16 a checkpoint round trip (save after step 1, step 2
   in a fresh ``Trainer`` restored from it within 1e-6 relative of the
   original's), 2 warm-up and 10 timed steps beside the Faster step's
   median and peak memory, K1-K4's launch counts rising, SyncBN's running
   statistics finite and moved in every layer, and the peak memory with
   remat; the process group is destroyed before the results;
13. drives the Mask R-CNN path (``mask_rcnn_r50_fpn_1x``: R50-FPN, 81
   classes, a 4 x conv256 mask head with a deconv, 28x28 masks from 14x14
   RoIAlign): K1 and K3 (with K3b) at P = 14 against their plain versions
   on 8 x 128 synthetic rois as in 2 and 5, and K3 against its plain model
   at C = 256, where small rois' bins overflow its shared-memory stage
   (the pairs read from g are logged); a small f32 input and training step
   on the card against the CPU as in 6 and 9, mask probabilities within
   1e-3; at 8x832x1344 in bf16 a warm-up and 20 timed batches of
   ``forward_test`` + ``rcnn_postprocess`` + ``mask_probs`` (K1 and K2
   twice a batch) and 2 warm-up and 10 timed steps of ``Trainer.run_step``
   with a box mask per gt (K1 and K3 twice, K4 three times a step); then K1
   on the first batch's detections and K1 and K3 on the first step's mask
   rois, in f32 and bf16, each with its pairs, longest list and the pairs
   read from g;
14. drives the RetinaNet path (``retinanet_r50_fpn_1x``: R50, FPN P3-P7
   with conv P6/P7, the 4 x conv256 subnets, 9 anchors a cell, 80
   classes), its class conv scaled (``CLASS_CONV_SCALE``) so that the seeded
   scores spread: a small f32 input and training step on the card against
   the CPU as in 6 and 9; at 8x832x1344 in bf16 a warm-up and 20 timed
   batches of ``forward_test`` + ``retinanet_postprocess`` (K2 once a
   batch) and 2 warm-up and 10 timed steps of ``Trainer.run_step`` (the
   focal loss over 209,538 anchors an image; K4's pass A and B once each a
   step), the launches a batch and a step checked;
15. drives the R-FCN path (``rfcn_r50_1x``: R50 with a dilated C5, a
   single-level RPN on C4, deformable PSRoIPool over 7 x 7 bins, OHEM),
   its class conv scaled likewise, as in 14 (K2 twice a batch; K2 once,
   K4's pass A twice and pass B once a step; the small step with OHEM
   keeping 16 of 32 rois), then K2 on the RPN problems of its first batch
   (8 x N = 6000) against its plain version, timed;
16. drives the evaluation path (``eval/evaluator.py``): the native RLE
   codec and COCO matcher must build from ``native/`` (into the package's
   ``_build/``); the ``Evaluator``'s per-image records of Mask R-CNN on 2
   synthetic images at 256x320 in f32 on the card against the CPU port's
   (labels equal, boxes within 1e-2 px, scores within 1e-4, every pasted
   mask's RLE IoU >= 0.99, the bbox and segm tables within 1e-3); then
   ``Evaluator.run`` of ``mask_rcnn_r50_fpn_1x`` (bf16, 8x832x1344 canvases,
   seeded weights) with bbox and segm over 32 synthetic images of 400-640 px
   with 3-6 objects each (the first batch untimed): images/s, the forward's
   seconds and the host's paste + RLE seconds, K1 twice and K2 twice a
   batch, both tables; then ``faster_rcnn_r50_fpn_1x`` with Gaussian
   Soft-NMS, box voting, flip TTA and a second scale (4 variants) for one
   timed batch, its peak memory, and Soft-NMS's time beside greedy NMS's
   and K2's on the candidates of one variant; then ``faster_rcnn_r50_voc``
   on 16 synthetic VOC images under the VOC protocol;
17. drives the training loop: ``Trainer.fit_epochs`` of
   ``faster_rcnn_r50_fpn_1x`` (batch 8, bf16, seeded weights) over the
   port's ``DetectionLoader`` on 24 synthetic images for one epoch under
   ``torch.profiler`` (step ms, the device's idle share, one metrics line a
   step, K1-K4's launch counts rising), the loader's images/s alone, a
   checkpoint, and ``python -m mxdetection_tpu_torch.tools.eval
   --checkpoint ... --synthetic 8`` in a subprocess, which must exit 0
   with the COCO table;
18. prints the card's name and power limit, the kernel table as one JSON
   line, then, as the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a CUDA device it
exits non-zero at once: there is no CPU fallback.

``python3 chip_smoke.py --profile DIR`` also splits an inference batch of
each detector and a training step into their stages (CUDA events at the
module boundaries; for Mask R-CNN the mask branch's RoIAlign, head, and
targets and loss) and traces each with ``torch.profiler``: kernel time by
name, the device's idle share, and Chrome traces written to
``DIR/<path>_trace.json.gz`` (``main_path``, ``cascade_path``,
``train_step``, ``cascade_train``, ``sync_bn_train``, ``mask_path``,
``mask_train``; the RetinaNet and R-FCN paths are not split).
``--k3-rois FILE`` saves phase 5's rois and the training step's to FILE,
for ``python -m mxdetection_tpu_torch.ops.cuda.k3_variants FILE`` and
``k1_variants --rois FILE``. ``--k2-boxes FILE`` saves the problems K2 was
handed in the first Faster R-CNN inference batch and training step, for
``k2_variants --boxes FILE``. ``--baseline DIR`` also runs the RoIAlign
forward of the checkout DIR (for example the parent commit, unpacked by
``git archive``) on phase 2's inputs.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work on this run's inputs: the largest of the bytes the function must
move (each input read once, each output written once) over 3.35 TB/s, its
f32 operations over 67 TFLOP/s (outside the tensor cores) and, for the
deformable conv's bf16 products (K5, K6), its tensor-core operations over 989
TFLOP/s: the H100 SXM's published peaks. K2's operations count an IoU
test (~14 operations) only for the (kept row, later valid row) pairs that
the greedy sweep needs on this run's data. K4's operations count an IoU
(~14 operations a pass) only for the (box, valid gt) pairs that overlap in
this run's data, and one comparison a pass for every other pair. The DCN
kernels' times, bounds and yardsticks are summed over the DCN layers of a
batch (K5, K5b) or of a training step (K6, K6b, K7, K7b).
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
K5_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:43"
K5B_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:622"
K6_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:261"
K6B_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:894"
K7_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:345"
K7B_REPLACES = "mxdetection_tpu/ops/pallas/dcn.py:804"
CASCADE = "cascade_rcnn_r101_dcn_1x"
SYNC = "multihost_dp_faster_rcnn_v5p16"
MASK = "mask_rcnn_r50_fpn_1x"
MASK_P = 14             # mask_head.roi_output_size
MASK_ROIS = 128         # the mask branch's rois a training image: the fg quota
MAIN_BATCH = 8
TIMED_BATCHES = 20
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_ROIS = 512        # bbox_head.num_samples
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# The DCN layers of Cascade R101-DCN at 8x832x1344: (stage, input H, W,
# channels, stride, layers of this shape a batch); Cin = Cout.
DCN_LAYERS = [
    ("stage2", 208, 336, 128, 2, 1), ("stage2", 104, 168, 128, 1, 3),
    ("stage3", 104, 168, 256, 2, 1), ("stage3", 52, 84, 256, 1, 22),
    ("stage4", 52, 84, 512, 2, 1), ("stage4", 26, 42, 512, 1, 2),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of work moving ``nbytes``, doing
    ``flops`` f32 operations and ``tc_flops`` bf16 tensor-core operations,
    on the card's published peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / F32_FLOPS, tc_flops / BF16_TC_FLOPS) * 1e3
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


def touched_pixels(shapes, rois, strides, levels, valid, p: int = 7) -> int:
    """Pixels of the pyramid that RoIAlign (P x P bins) reads with a nonzero
    weight for these rois: where the gradient of the plain version, on one
    channel of ones, is nonzero."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra

    b = rois.shape[0]
    ones = [torch.ones((b, h, w, 1), device=rois.device, requires_grad=True) for h, w in shapes]
    out = ra.multilevel_roi_align_plain(ones, rois, strides, levels, output_size=p,
                                        roi_valid=valid)
    return sum(int((g != 0).sum()) for g in torch.autograd.grad(out.sum(), ones))


def roi_flops(n_valid: int, p: int, s: int, c: int) -> float:
    """Four taps of a bilinear sample, a multiply and an add each."""
    return float(n_valid) * p * p * s * s * c * 8


def l2_copy_rate() -> float:
    """Bytes a second of a copy whose 2 x 16 MiB stay in the 50 MB L2 (read
    and write counted): about the rate a gather that L2 serves can reach."""
    import torch

    x = torch.empty(4 << 20, dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    return 2 * x.numel() * 4 / (time_ms(lambda: y.copy_(x), reps=200) * 1e-3)


def k1_check(got, ref, valid, dtype) -> tuple[bool, float, str]:
    """K1's rule against its plain version: (ok, max |err|, rule)."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == torch.float32:
        ok, rule = err.max().item() <= 1e-5, "atol 1e-5"
    else:  # one bf16 rounding step: the two f32 sums may round to neighbours
        ok, rule = bool((err <= 2.0 ** -7 * ref.abs() + 1e-5).all()), "|err| <= 2^-7 |ref| + 1e-5"
    if not torch.isfinite(got).all() or (got[~valid] != 0.0).any():
        fail(f"K1 {dtype}: non-finite output or nonzero invalid rows")
    return ok, err.max().item(), rule


def phase_roi_align(device, baseline: str | None = None) -> dict:
    """K1 against its plain version at phase 2's rois (8 x 1000 over P2-P5
    of 832x1344, C = 256, P = 7) as ``k1_synthetic`` checks them; its ptxas
    lines (failing on spills); with ``baseline``, the largest difference
    from that checkout's kernel on the same inputs."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas_facts("roi_align_fwd_kernel", "K1")
    return k1_synthetic(device, 7, 1000, torch.Generator().manual_seed(1), baseline)


def k1_synthetic(device, p: int, r: int, gen, baseline: str | None = None) -> dict:
    """K1 (P x P bins) against its plain version on 8 x ``r`` synthetic rois
    over P2-P5 of 832x1344, C = 256, in f32 and bf16, and at C = 131 (the
    lanes' loads channel by channel); the bytes its taps gather and their
    time at the L2 copy rate."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_cuda

    b, strides, tag = MAIN_BATCH, (4, 8, 16, 32), f"K1 P={p}"
    rois, valid = main_path_rois(b, r, gen, device)
    levels = ra.roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    log(f"{tag} rois per level: {torch.bincount(levels.flatten().long(), minlength=4).tolist()}")
    shapes = [(208, 336), (104, 168), (52, 84), (26, 42)]
    pixels = touched_pixels(shapes, rois, strides, levels, valid, p)
    n_valid = int(valid.sum())
    # bf16: touched pixels read, output written, rois/levels/valid read
    nbytes = (pixels * 256 * 2 + b * r * p * p * 256 * 2 + b * r * (16 + 4 + 1))
    bound_ms, bound_by = bound(nbytes, roi_flops(n_valid, p, 2, 256))
    gathered = n_valid * p * p * 4 * 4 * 256 * 2
    l2_rate = l2_copy_rate()
    log(f"{tag} bound (bf16): {pixels} pyramid pixels touched, {nbytes / 1e6:.1f} MB moved, "
        f"{bound_ms:.4f} ms, bound by {bound_by}; the taps gather {gathered / 1e9:.3f} GB, "
        f"{gathered / l2_rate * 1e3:.4f} ms at the L2 copy rate ({l2_rate / 1e12:.2f} TB/s "
        "measured)")
    old = None
    if baseline:
        from mxdetection_tpu_torch.ops.cuda.k1_variants import baseline_kernel

        old = baseline_kernel(baseline)
    result = {"bound_ms": bound_ms, "bound_by": bound_by, "gathered_bytes": gathered,
              "l2_copy_tb_s": l2_rate / 1e12}
    for dtype in (torch.float32, torch.bfloat16):
        feats = main_path_pyramid(b, dtype, gen, device)
        kernel = lambda: roi_align_cuda(feats, rois, strides, levels, output_size=p,
                                        roi_valid=valid)
        plain = lambda: ra.multilevel_roi_align_plain(feats, rois, strides, levels,
                                                      output_size=p, roi_valid=valid)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        ok, max_abs, rule = k1_check(got, ref, valid, dtype)
        plain_ms = time_ms(plain, reps=5)
        ms = time_ms(kernel)
        plain_ms = (plain_ms + time_ms(plain, reps=5)) / 2
        log(f"{tag} roi_align {dtype}: max_abs_err {max_abs:.3e} ({rule}: "
            f"{'ok' if ok else 'FAILED'}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(B={b}, R={r}, C=256, P={p}, P2-P5 of 832x1344)")
        if not ok:
            fail(f"{tag} disagrees with its plain version in {dtype}")
        result[str(dtype).replace("torch.", "")] = {"max_abs_err": max_abs, "ms": ms,
                                                   "plain_ms": plain_ms}
        if old is not None:
            prev = old(feats, rois, strides, levels, valid)
            diff = (got.float() - prev.float()).abs().max().item()
            log(f"K1 {dtype}: largest difference from {baseline}'s kernel {diff:.3e}; its time "
                f"{time_ms(lambda: old(feats, rois, strides, levels, valid)):.4f} ms")
    for dtype in (torch.float32, torch.bfloat16):  # a width the 16-byte loads cannot take
        feats = [f[..., :131].contiguous() for f in main_path_pyramid(2, dtype, gen, device)]
        got = roi_align_cuda(feats, rois[:2], strides, levels[:2], output_size=p,
                             roi_valid=valid[:2])
        ref = ra.multilevel_roi_align_plain(feats, rois[:2], strides, levels[:2], output_size=p,
                                            roi_valid=valid[:2])
        ok, max_abs, rule = k1_check(got, ref, valid[:2], dtype)
        log(f"{tag} roi_align {dtype}, C=131 (2 x {r} rois): max_abs_err {max_abs:.3e} ({rule}: "
            f"{'ok' if ok else 'FAILED'})")
        if not ok:
            fail(f"{tag} disagrees with its plain version at C=131 in {dtype}")
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


def nms_cases(device) -> list:
    """[(name, IoU threshold, (boxes, valid))]: K2's three main-path shapes
    (Faster R-CNN's; RetinaNet's and R-FCN's test NMS is ``class_aware``'s)."""
    import torch

    gen = torch.Generator().manual_seed(2)
    b = MAIN_BATCH
    return [
        ("rpn", 0.7, nms_problems(b * 5, 1000, [1000, 1000, 1000, 1000, 819] * b, gen, device)),
        ("class_aware", 0.5, nms_problems(b, 1000, [1000] * b, gen, device, labels=True)),
        # the training proposals: pre_nms_top_n_train 2000 per level; P6 of
        # 832x1344 has 819 anchors
        ("rpn_train", 0.7, nms_problems(b * 5, 2000, [2000, 2000, 2000, 2000, 819] * b, gen,
                                        device)),
    ]


def nms_edge_cases(device) -> list:
    """[(name, IoU threshold, (boxes, valid))]: awkward problems for K2. Ragged
    N (1, 63, 64, 65, 130) with problems of different valid counts; N = 2100
    and 5000 (more than one 32-word chunk a row tile) with invalid rows among
    the valid ones; a problem with no valid row; NaN, zero-area and
    duplicated boxes; one box that suppresses every later row; IoUs exactly
    at the threshold (0.5 and 0.7, each exact in f32 arithmetic)."""
    import torch

    gen = torch.Generator().manual_seed(6)
    cases = [(f"n{n}", 0.7, nms_problems(len(counts), n, counts, gen, device))
             for n, counts in ((1, [1, 0]), (63, [63, 40]), (64, [64, 1]), (65, [65, 64]),
                               (130, [130, 129, 66, 2]))]
    for n in (2100, 5000):
        boxes, valid = nms_problems(2, n, [n, n - 37], gen, device)
        holes = torch.rand(valid.shape, generator=gen).to(device) < 0.1
        cases.append((f"n{n}_holes", 0.7, (boxes, valid & ~holes)))
    boxes, valid = nms_problems(2, 300, [300, 300], gen, device)
    cases.append(("all_invalid", 0.7, (boxes, torch.zeros_like(valid))))
    boxes, valid = nms_problems(3, 200, [200, 200, 150], gen, device)
    boxes[:, 5::17, 1] = float("nan")
    boxes[:, 9::23] = 0.0                       # zero area
    boxes[2, 3, 2] = boxes[2, 3, 0]             # zero width
    boxes[:, 40:60] = boxes[:, 20:40].clone()   # duplicates of earlier rows
    cases.append(("nan_zero_dup", 0.5, (boxes, valid)))
    first = torch.tensor([100.0, 100.0, 300.0, 300.0])
    jitter = torch.rand((2, 500, 4), generator=gen) * 2.0 - 1.0
    cases.append(("suppress_all", 0.7, ((first + jitter).to(device),
                                        torch.ones((2, 500), dtype=torch.bool, device=device))))
    # four pairs apart; the second box of each at IoU exactly 0.7 (70 / 100),
    # exactly 0.5 (50 / 100), just over 0.5 and just over 0.7 with the first
    at = torch.tensor([[x, 0.0, x + 10.0, 10.0] for x in (0.0, 20.0, 40.0, 60.0)]
                      + [[0.0, 0.0, 10.0, 7.0], [20.0, 0.0, 30.0, 5.0],
                         [40.0, 0.0, 50.0, 5.0001], [60.0, 0.0, 70.0, 7.0001]])
    for thr in (0.5, 0.7):
        cases.append((f"at_thr_{thr}", thr, (at[None].to(device),
                                             torch.ones((1, 8), dtype=torch.bool, device=device))))
    return cases


def k2_bound(keep, valid) -> tuple[float, str, int]:
    """(bound ms, by, IoU pairs) of K2 on this run's data: boxes and valid
    read once and keep written once, and an IoU test (~14 f32 operations)
    for each pair the greedy sweep needs, a kept row and a later valid row."""
    later = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()  # valid rows after each row
    pairs = int((later * keep).sum())
    p, n = valid.shape
    return (*bound(p * n * (16 + 1 + 1), pairs * 14), pairs)


def k2_build_facts() -> None:
    """Log ptxas's lines of K2 (``nms_mask_kernel``, ``nms_sweep_kernel``),
    failing on spills, and the shared-memory atomics and warp reductions in
    the sweep's SASS (the removed set is ORed by owner warps, no atomics)."""
    funcs = ptxas_facts("nms_", "K2")
    for fname, func in funcs.items():
        if "sweep" in fname:
            log(f"K2 sweep SASS (cuobjdump): ATOMS {func.count('ATOMS')}, "
                f"CAS {func.count('CAS')}, REDUX {func.count('REDUX')}, "
                f"UBLKCP {func.count('UBLKCP')}")


def nms_shares(boxes, valid, keep) -> dict:
    """What K2's work depends on in one set of problems: the share of valid
    rows kept, and of the (valid row, later column) pairs its mask kernel
    tests, the share that do not intersect (they decide without the
    division, as in ``iou_over``)."""
    import torch

    n = valid.shape[1]
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    tested = disjoint = 0
    for b, v in zip(boxes.float(), valid):
        wh = torch.minimum(b[:, None, 2:], b[None, :, 2:]) - \
            torch.maximum(b[:, None, :2], b[None, :, :2])
        pairs = later & v[:, None]
        tested += int(pairs.sum())
        disjoint += int((pairs & ~((wh[..., 0] > 0) & (wh[..., 1] > 0))).sum())
    return {"keep_share": int(keep.sum()) / max(int(valid.sum()), 1),
            "disjoint_share": disjoint / max(tested, 1), "tested_pairs": tested}


def k2_case(name: str, thr: float, boxes, valid) -> dict:
    """K2 bit for bit against its plain version on one set of problems,
    timed beside it, with the bound from the plain keep mask and the shares
    of ``nms_shares``; fails on any differing keep bit."""
    import torch

    from mxdetection_tpu_torch.ops.cuda.nms import nms_mask_sorted_cuda
    from mxdetection_tpu_torch.ops.nms import nms_mask_sorted_plain

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
    bound_ms, bound_by, pairs = k2_bound(ref, valid)
    shares = nms_shares(boxes, valid, ref)
    log(f"K2 nms {name}: {(p, n)} problems x N, thr {thr}: "
        f"kept {int(ref.sum())}/{int(valid.sum())} ({shares['keep_share']:.4f}), disjoint "
        f"share of the {shares['tested_pairs']} tested pairs {shares['disjoint_share']:.4f}, "
        f"mismatched keep bits {mismatches}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} (kept, later valid) pairs)")
    if mismatches:
        fail(f"K2 keep mask differs from its plain version ({name})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "pairs": pairs, "max_abs_err": err.max().item(), **shares}


def rfcn_rpn_case(device):
    """R-FCN's RPN problem: one level, so one problem an image of its top
    N = 6000 anchors (of 52,416), IoU 0.7, batch ``MAIN_BATCH``."""
    import torch

    return nms_problems(MAIN_BATCH, 6000, [6000] * MAIN_BATCH, torch.Generator().manual_seed(14),
                        device)


def phase_nms(device) -> dict:
    """K2 bit for bit against its plain version at the three main-path
    shapes (timed, with the bound from each run's keep mask; their times
    summed), at R-FCN's RPN shape (8 x 6000, timed apart) and on
    ``nms_edge_cases``."""
    from mxdetection_tpu_torch.ops.cuda.nms import nms_mask_sorted_cuda
    from mxdetection_tpu_torch.ops.nms import nms_mask_sorted_plain

    k2_build_facts()
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, thr, (boxes, valid) in nms_cases(device):
        case = result[name] = k2_case(name, thr, boxes, valid)
        result["max_abs_err"] = max(result["max_abs_err"], case["max_abs_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            result[k] += case[k]
        result["bound_by"] = case["bound_by"]
    result["rfcn_rpn"] = k2_case("rfcn_rpn", 0.7, *rfcn_rpn_case(device))
    result["max_abs_err"] = max(result["max_abs_err"], result["rfcn_rpn"]["max_abs_err"])
    for name, thr, (boxes, valid) in nms_edge_cases(device):
        got = nms_mask_sorted_cuda(boxes, valid, thr)
        ref = nms_mask_sorted_plain(boxes, valid, thr)
        mismatches = int((got != ref).sum())
        log(f"K2 edge case {name}: {tuple(valid.shape)} problems x N, thr {thr}: kept "
            f"{ref.sum(-1).tolist()} of {valid.sum(-1).tolist()} valid, mismatched keep bits "
            f"{mismatches}")
        if mismatches:
            fail(f"K2 keep mask differs from its plain version (edge case {name})")
    return result


# --------------------------------------------------------------------------
# phase 4: K4


def k4_rpn_case(device, gen):
    """The RPN assigner's inputs at 8x832x1344: the canvas's 279,279 anchors
    (one set, expanded over the batch), 100 gt rows an image of which every
    10th is padding, and the ``inside`` mask of an 800x1333 image, as
    ``rcnn_loss`` builds them. Image 2 repeats gt rows (argmax ties), image
    3 has two gt whose best anchor is one and the same (the last-gt rule),
    image 4 has no valid gt."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.detectors.rcnn import rpn_level_anchors

    cfg = load_config("faster_rcnn_r50_fpn_1x")
    anchors = torch.cat(rpn_level_anchors(cfg, (832, 1344), device=device), 0)
    b, n, g = MAIN_BATCH, anchors.shape[0], 100
    xy = torch.rand((b, g, 2), generator=gen) * torch.tensor([1300.0, 780.0])
    wh = torch.exp(torch.rand((b, g, 2), generator=gen) * 4.0 + 2.0)  # 7 .. 400 px
    gt = torch.cat([xy, xy + wh], -1)
    valid = torch.ones((b, g), dtype=torch.bool)
    valid[:, ::10] = False
    gt[:, ::10] = 0.0                      # padding rows
    gt[2, 50:60] = gt[2, 41:51].clone()    # duplicates: the first wins the argmax
    a = anchors[n // 2].cpu()              # two gt, one best anchor: the last is forced
    gt[3, 1] = a + torch.tensor([-3.0, -2.0, 3.0, 2.0])
    gt[3, 2] = a + torch.tensor([3.0, 2.0, -3.0, -2.0])
    valid[4] = False
    hw = torch.tensor([800.0, 1333.0], device=device)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] <= hw[1])
              & (anchors[:, 3] <= hw[0]))
    return anchors.expand(b, n, 4), gt.to(device), valid.to(device), \
        inside[None].expand(b, n).contiguous()


def k4_retinanet(device, gen) -> dict:
    """K4's route at RetinaNet's assignment: the 209,538 anchors of P3-P7
    of an 832x1344 canvas (one set, expanded over the batch), the RPN
    case's gt rows, IoU 0.5 / 0.4, the low-quality force on and no
    ``box_valid``, as ``retinanet_loss`` calls it: labels, matched and
    max_iou bit for bit against the dense plain assigner, timed beside it,
    with the route's peak memory and its bound on this data."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.detectors.retinanet import make_anchors
    from mxdetection_tpu_torch.ops import matching
    from mxdetection_tpu_torch.ops.cuda import iou as iou_cuda

    anchors = make_anchors(load_config("retinanet_r50_fpn_1x"), (832, 1344), device=device)
    _, gt, gt_valid, _ = k4_rpn_case(device, gen)
    b, n, g = gt.shape[0], anchors.shape[0], gt.shape[1]
    boxes = anchors.expand(b, n, 4)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, match_low_quality=True)
    route = lambda: matching.assign_max_iou(boxes, gt, gt_valid, **kw)  # noqa: E731
    plain = lambda: matching.assign_max_iou_dense(boxes, gt, gt_valid, **kw)  # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = (iou_cuda.pass_a_count.n, iou_cuda.pass_b_count.n)
    got = route()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = (iou_cuda.pass_a_count.n - counts[0], iou_cuda.pass_b_count.n - counts[1])
    ref = plain()
    same = [torch.equal(x, y) for x, y in zip(got, ref)]
    overlap = int((matching.masked_iou(boxes, gt, gt_valid) > 0).sum())
    n_valid = int(gt_valid.sum())
    ms = time_ms(route)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    nbytes = n * 16 + b * g * (16 + 1 + 4) + b * n * (4 + 8 + 4)
    bound_ms, bound_by = bound(nbytes, 2.0 * (overlap * 14 + n * n_valid))
    pos = int((ref.labels == 1).sum())
    forced = int(((ref.labels == 1) & (ref.max_iou < 0.5)).sum())
    log(f"K4 assign, RetinaNet shape {(b, n, g)}, low-quality True, no box_valid: "
        f"matched/labels/max_iou bit-identical to the dense plain version: {same}; {pos} "
        f"positive ({forced} forced below 0.5); pass A + pass B {launches[0]} + {launches[1]} "
        f"launches; route {ms:.4f} ms, dense plain {plain_ms:.4f} ms; {overlap} of "
        f"{n * n_valid} (box, valid gt) pairs overlap; bound {bound_ms:.4f} ms ({bound_by}); "
        f"peak {peak / 2**20:.1f} MiB above the inputs")
    if not all(same):
        fail("K4 assign differs from the dense plain assigner at RetinaNet's shape")
    if launches != (1, 1):
        fail(f"K4 at RetinaNet's shape: {launches} launches of pass A and B, expected (1, 1)")
    if peak >= b * n * g:
        fail(f"K4 assign at RetinaNet's shape took {peak} bytes, a byte a (box, gt) pair")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "overlap_pairs": overlap, "peak_mib": peak / 2**20,
            "max_abs_err": (got.max_iou - ref.max_iou).abs().max().item()}


def k4_facts() -> None:
    """Log ptxas's lines of K4 (``max_iou_kernel``, one instantiation a
    mode), failing on spills."""
    ptxas_facts("max_iou_kernel", "K4")


def phase_iou(device) -> dict:
    """K4, the max-IoU assigner, bit for bit against the dense plain
    ``assign_max_iou_dense`` (the whole IoU matrix, plain ``pairwise_iou``)
    at the RPN assigner's shape (``k4_rpn_case``: padding, ties, a shared
    best anchor, an image without gt, the inside mask), with and without the
    low-quality force, and its pass A (each row's max and first argmax)
    against the dense row max at ``sample_rois``' shape (8 x 1100 x 100: the
    gt then 1000 proposals) and ``relabel_rois``' (8 x 512 x 100); the RPN
    route's peak memory must stay under a byte a (box, gt) pair; then the
    route at RetinaNet's shape (``k4_retinanet``)."""
    import torch

    from mxdetection_tpu_torch.ops import matching
    from mxdetection_tpu_torch.ops.cuda import iou as iou_cuda

    k4_facts()
    gen = torch.Generator().manual_seed(5)
    boxes, gt, gt_valid, inside = k4_rpn_case(device, gen)
    b, n, g = boxes.shape[0], boxes.shape[1], gt.shape[1]
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, box_valid=inside)
    result = {"max_abs_err": 0.0}
    for lq in (True, False):
        route = lambda: matching.assign_max_iou(boxes, gt, gt_valid,  # noqa: E731
                                                match_low_quality=lq, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = route()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ref = matching.assign_max_iou_dense(boxes, gt, gt_valid, match_low_quality=lq, **kw)
        same = [torch.equal(x, y) for x, y in zip(got, ref)]
        err = (got.max_iou - ref.max_iou).abs().max().item()
        forced = int(((ref.labels == 1) & (ref.max_iou < 0.7)).sum())
        m2 = ref.matched_gt[2][ref.max_iou[2] > 0]
        copies = (int(((m2 >= 42) & (m2 <= 49)).sum()), int(((m2 >= 51) & (m2 <= 58)).sum()))
        shared = int(ref.matched_gt[3, n // 2])
        log(f"K4 assign, RPN shape {(b, n, g)}, low-quality {lq}: matched/labels/max_iou "
            f"bit-identical to the dense plain version: {same}; {int((ref.labels == 1).sum())} "
            f"positive ({forced} forced below 0.7), {int((ref.labels == -2).sum())} outside; "
            f"image 2's boxes matched to the first / second copy of a duplicated gt {copies}; "
            f"image 3's shared best anchor matched to gt {shared}; image 4 (no gt) labels "
            f"{sorted(set(ref.labels[4].tolist()))}; peak {peak / 2**20:.1f} MiB above the "
            f"inputs (an IoU matrix: {b * n * g * 4 / 2**20:.0f})")
        if not all(same):
            fail(f"K4 assign (low-quality {lq}) differs from the dense plain assigner")
        if lq and shared != 2:
            fail("K4 case: gt 1 and 2 of image 3 do not share their best anchor")
        if peak >= b * n * g:
            fail(f"K4 assign: the route took {peak} bytes, at least a byte a (box, gt) pair")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if lq:
            n_valid = int(gt_valid.sum())
            # pairs of a valid gt with a nonzero IoU: only these need the
            # IoU's ~14 f32 operations, in each of the two passes; every
            # other pair needs at least one comparison a pass
            iou = matching.masked_iou(boxes, gt, gt_valid)
            overlap = int((iou > 0).sum())
            del iou
            plain = lambda: matching.assign_max_iou_dense(  # noqa: E731
                boxes, gt, gt_valid, match_low_quality=True, **kw)
            counts = (iou_cuda.pass_a_count.n, iou_cuda.pass_b_count.n)
            ms = time_ms(route)
            plain_ms = time_ms(plain, reps=3, warmup=1)
            # the anchors once, the gt and masks, each row's three outputs
            nbytes = n * 16 + b * g * (16 + 1 + 4) + b * n * (1 + 4 + 8 + 4)
            bound_ms, bound_by = bound(nbytes, 2.0 * (overlap * 14 + n * n_valid))
            log(f"K4 assign route (pass A + pass B, {iou_cuda.pass_a_count.n - counts[0]} + "
                f"{iou_cuda.pass_b_count.n - counts[1]} launches timed): {ms:.4f} ms; dense "
                f"plain {plain_ms:.4f} ms; {n_valid} valid gt, {overlap} (box, valid gt) pairs "
                f"of {n * n_valid} overlap; bound {bound_ms:.4f} ms ({bound_by}: "
                f"{nbytes / 1e6:.1f} MB)")
            result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          overlap_pairs=overlap, peak_mib=peak / 2**20)
    for what, props in (
            ("sample_rois", torch.cat([gt, main_path_rois(b, 1000, gen, device)[0]], 1)),
            ("relabel_rois", main_path_rois(b, TRAIN_ROIS, gen, device)[0])):
        rows = props.shape[1]
        got = matching.max_iou_rows(props, gt, gt_valid)
        ref = matching.masked_iou(props, gt, gt_valid).max(dim=-1)
        same = [torch.equal(x, y) for x, y in zip(got, ref)]
        ms = time_ms(lambda: matching.max_iou_rows(props, gt, gt_valid))
        log(f"K4 pass A, {what} shape {(b, rows, g)}: max_iou/matched bit-identical to the "
            f"dense row max: {same}; {ms:.4f} ms")
        if not all(same):
            fail(f"K4 pass A differs from the dense row max at the {what} shape")
        result[what] = {"ms": ms}
    result["retinanet"] = k4_retinanet(device, gen)
    result["max_abs_err"] = max(result["max_abs_err"], result["retinanet"]["max_abs_err"])
    return result


# --------------------------------------------------------------------------
# phase 5: K3 + K3b


def k3_build_facts() -> None:
    """Log ptxas's lines of K3 (``roi_align_bwd_kernel``, one instantiation
    a pair of g and output dtypes), failing on spills, and the partition the
    built kernel reports (``roi_align_bwd_layout_cuda``), failing where it is
    not the plain model's (``roi_align_bwd_config``, read from the source)."""
    from mxdetection_tpu_torch.ops.cuda.roi_align import (roi_align_bwd_config,
                                                          roi_align_bwd_layout_cuda)

    ptxas_facts("roi_align_bwd_kernel", "K3")
    built, model = roi_align_bwd_layout_cuda(), roi_align_bwd_config()
    same = built == model
    log(f"K3 partition: built kernel {built}, plain model {model}: "
        f"{'same' if same else 'DIFFERENT'}")
    if not same:
        fail("K3: the built kernel's tile or chunk is not the plain model's")


K3_MODEL_CASES = ((131, 2), (64, 2), (64, 3))  # (C, S) at P = 7


def k3_model_check(device, p: int = 7, cases=K3_MODEL_CASES) -> None:
    """K3 against its plain model (``roi_align_bwd_tiles``), bit for bit, on
    ragged maps (neither side a multiple of the tile) with rois of every
    kind the CPU tests name: overhanging and outside the map, narrower than
    a cell, past 40:1, at the last row and column, and a cluster on one
    tile; at P = 7 C = 131 (a ragged last chunk, scalar loads) and 64
    (vector loads), S = 2 and 3 (g / 9 rounded through f64), g in f32 and
    bf16; at P = 14 C = 256, where some rois' bins take more than K3's
    stage and are read from g, the branch the main paths rarely take (the
    pairs read from g are logged). The model, a loop of small ops, runs on
    the CPU; its f32 products and sums round as on the card."""
    import torch

    from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_bwd_cuda, roi_align_bwd_tiles

    gen = torch.Generator().manual_seed(16)
    shapes, strides = [(19, 13), (10, 7)], (4, 8)
    cx = torch.cat([torch.rand(20, generator=gen) * 70 - 10, torch.full((12,), 30.0)])
    cy = torch.cat([torch.rand(20, generator=gen) * 100 - 10, torch.full((12,), 40.0)])
    side = torch.exp(torch.rand(32, generator=gen) * 4.0 + 0.5)
    aspect = torch.exp(torch.randn(32, generator=gen) * 1.5)
    w, h = side * aspect.sqrt(), side / aspect.sqrt()
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    rois[20:] += torch.randn((12, 4), generator=gen)  # the cluster
    rois[0] = torch.tensor([1.0, 2.0, 1.5, 2.2])       # narrower than a cell
    rois[1] = torch.tensor([0.0, 30.0, 52.0, 31.0])    # 52:1
    rois[2] = torch.tensor([40.0, 60.0, 60.0, 90.0])   # at the last row and column
    rois[3] = torch.tensor([-40.0, -30.0, -8.0, -6.0])  # outside the map
    rois = torch.stack([rois, rois.flip(0)]).to(device)
    valid = (torch.rand((2, 32), generator=gen) > 0.1).to(device)
    levels = (torch.rand((2, 32), generator=gen) > 0.6).int().to(device)
    for c, s in cases:
        g32 = torch.randn((2, 32, p, p, c), generator=gen).to(device)
        for g in (g32, g32.bfloat16()):
            model, pairs, longest = roi_align_bwd_tiles(
                g.cpu(), shapes, rois.cpu(), strides, levels.cpu(), sampling_ratio=s,
                roi_valid=valid.cpu())
            got = roi_align_bwd_cuda(g, shapes, rois, strides, levels, sampling_ratio=s,
                                     roi_valid=valid)
            same = all(torch.equal(a.cpu(), m) for a, m in zip(got, model))
            taps = roi_cuda.roi_sample_taps(rois, levels, shapes, strides, output_size=p,
                                            sampling_ratio=s)
            unstaged = roi_cuda.roi_stage_pairs(
                taps, roi_cuda.roi_footprints(taps, valid), levels, shapes, channels=c,
                itemsize=g.element_size(), sampling_ratio=s)[2]
            log(f"K3 vs its plain model, P={p}, C={c}, S={s}, g {g.dtype}, maps {shapes}: "
                f"{'bit-identical' if same else 'DIFFERENT'} ({pairs} (roi, tile) pairs, "
                f"longest list {longest}, {unstaged} pairs read from g)")
            if not same:
                fail(f"K3 differs from roi_align_bwd_tiles at P={p}, C={c}, S={s}, g {g.dtype}")


def phase_roi_align_bwd(device) -> dict:
    """K3 (K3b as its bf16 epilogue): its build facts, its plain model, and
    ``k3_synthetic`` at training shapes (8 x 512 rois, P = 7)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k3_build_facts()
    k3_model_check(device)
    return k3_synthetic(device, 7, TRAIN_ROIS, torch.Generator().manual_seed(6))


def k3_stage_facts(shapes, strides, rois, levels, valid, p: int, g) -> dict:
    """K3's (roi, tile) pairs, its longest roi list, and the pairs (and
    rois) whose bins of ``g`` do not fit its shared-memory stage, which it
    reads from g (``roi_stage_pairs``)."""
    from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda

    taps = roi_cuda.roi_sample_taps(rois, levels, shapes, strides, output_size=p)
    pairs, longest, unstaged, by_roi = roi_cuda.roi_stage_pairs(
        taps, roi_cuda.roi_footprints(taps, valid), levels, shapes, channels=g.shape[-1],
        itemsize=g.element_size())
    return {"pairs": pairs, "longest_list": longest, "unstaged_pairs": unstaged,
            "unstaged_rois": int(by_roi.sum())}


def k3_synthetic(device, p: int, r: int, gen) -> dict:
    """K3 (K3b as its bf16 epilogue) on 8 x ``r`` synthetic rois over P2-P5
    of 832x1344 with a P x P upstream gradient of C = 256, against torch
    autograd of K1's plain version on the same rois, levels and gradient;
    two runs bit for bit."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_bwd_cuda

    b, strides, tag = MAIN_BATCH, (4, 8, 16, 32), f"K3 P={p}"
    rois, valid = main_path_rois(b, r, gen, device)
    levels = ra.roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    feats = main_path_pyramid(b, torch.float32, gen, device)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    g16 = torch.randn((b, r, p, p, 256), generator=gen).to(device=device, dtype=torch.bfloat16)
    g32 = g16.float()
    result = {"rois": {"rois": rois.cpu(), "levels": levels.cpu(), "valid": valid.cpu()},
              "shapes": shapes, "strides": strides,
              **k3_stage_facts(shapes, strides, rois, levels, valid, p, g16)}
    log(f"{tag} synthetic rois: {result['pairs']} (roi, tile) pairs, longest list "
        f"{result['longest_list']}; with bf16 g {result['unstaged_pairs']} pairs of "
        f"{result['unstaged_rois']} rois read from g, their bins past the stage")

    leaves = [f.requires_grad_() for f in feats]
    out = ra.multilevel_roi_align_plain(leaves, rois, strides, levels, output_size=p,
                                        roi_valid=valid)
    plain = lambda: torch.autograd.grad(out, leaves, g32, retain_graph=True)
    ref = plain()
    scale = max(x.abs().max().item() for x in ref)
    run = lambda g, dtype: roi_align_bwd_cuda(g, shapes, rois, strides, levels,  # noqa: E731
                                              roi_valid=valid, out_dtype=dtype)
    f32 = run(g32, torch.float32)
    torch.cuda.synchronize()
    max_abs = max((a - e).abs().max().item() for a, e in zip(f32, ref))
    ok = max_abs <= 1e-5 * scale
    again = all(torch.equal(a, x) for a, x in zip(f32, run(g32, torch.float32)))
    from_bf16 = all(torch.equal(a, x) for a, x in zip(f32, run(g16, torch.float32)))
    bf16 = run(g16, torch.bfloat16)
    rounded = all(torch.equal(x, a.to(torch.bfloat16)) for x, a in zip(bf16, f32))
    k3b_err = max((x.float() - a.to(torch.bfloat16).float()).abs().max().item()
                  for x, a in zip(bf16, f32))
    log(f"{tag} roi_align_bwd f32: max_abs_err {max_abs:.3e} of max|ref| {scale:.3e} "
        f"(max|err| <= 1e-5 max|ref|, the sums in another order: {'ok' if ok else 'FAILED'}); "
        f"two runs bit-identical: {again}; from bf16 g (the same values) bit-identical: "
        f"{from_bf16}; K3b: bf16 out equal to the f32 out .to(bfloat16): {rounded}")
    if not ok:
        fail(f"{tag} disagrees with autograd of the plain RoIAlign in float32")
    if not (again and from_bf16):
        fail(f"{tag}: two runs on the same values differ")
    if not rounded:
        fail(f"{tag}: the bf16 gradient (K3b) is not the f32 gradient rounded to nearest even")
    plain_ms = time_ms(plain, reps=3, warmup=1)
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        ms = time_ms(lambda: run(g, dtype))
        log(f"{tag} roi_align_bwd {dtype} (g and gradients): {ms:.4f} ms, autograd of plain "
            f"{plain_ms:.4f} ms (B={b}, R={r}, C=256, P={p}, P2-P5 of 832x1344)")
        result[str(dtype).replace("torch.", "")] = {"max_abs_err": max_abs, "ms": ms,
                                                   "plain_ms": plain_ms}
    n_valid = int(valid.sum())
    pixels = sum(h * w for h, w in shapes) * b
    # bf16: g of the valid rois read, every level gradient written once
    k3_bytes = n_valid * p * p * 256 * 2 + pixels * 256 * 2 + b * r * (16 + 4 + 1)
    result["bound_ms"], result["bound_by"] = bound(k3_bytes, roi_flops(n_valid, p, 2, 256))

    # K3b is the bf16 epilogue of the same kernel: it has no time of its own.
    # Its entry carries the fused kernel's bf16 time and bound, and beside
    # them what the separate convert it replaced costs at least: one
    # .to(bfloat16) of the 190 M f32 values (its plain version and library call).
    acc = torch.cat([a.flatten() for a in f32])
    convert_ms = time_ms(lambda: acc.to(torch.bfloat16))
    result["k3b"] = {"max_abs_err": k3b_err, "ms": result["bfloat16"]["ms"],
                     "plain_ms": convert_ms, "library_ms": convert_ms,
                     "bound_ms": result["bound_ms"], "bound_by": result["bound_by"]}
    log(f"K3b (fused): {acc.numel()} values; .to(bfloat16) alone {convert_ms:.4f} ms; K3 "
        f"bound {result['bound_ms']:.4f} ms ({result['bound_by']}) for {n_valid} valid rois")
    return result


class CaptureRoi:
    """While active, keeps a copy of the rois, levels and validity of the
    first call of the RoIAlign backward's wrapper (``backward``) or of the
    forward's, at output size ``p`` if given (the autograd Function reads
    the wrappers from their module at each call), and the shape and dtype
    of its upstream gradient (or of its output, the same): nothing large,
    so the step's peak memory is its own."""

    def __init__(self, backward: bool = True, p: int | None = None):
        from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda

        self.module, self.first, self.p = roi_cuda, None, p
        self.name = "roi_align_bwd_cuda" if backward else "roi_align_cuda"

    def __enter__(self):
        inner = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            if self.name == "roi_align_bwd_cuda":
                grad_out, shapes, rois, strides, levels = args
                g = (tuple(grad_out.shape), grad_out.dtype)
            else:
                feats, rois, strides, levels = args
                p = kw["output_size"]
                g = ((*rois.shape[:2], p, p, feats[0].shape[-1]), feats[0].dtype)
                shapes = [tuple(f.shape[1:3]) for f in feats]
            if self.first is None and self.p in (None, g[0][2]):
                self.first = {"g": g, "shapes": list(shapes), "rois": rois.clone(),
                              "strides": tuple(strides), "levels": levels.clone(),
                              "roi_valid": kw["roi_valid"].clone()}
            return inner(*args, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class CaptureNms:
    """While active, keeps a copy of the boxes, validity and IoU threshold
    of the first ``limit`` calls of K2's wrapper (``ops/nms.py`` reads it
    from its module at each call): the problems a path hands K2."""

    def __init__(self, limit: int):
        from mxdetection_tpu_torch.ops.cuda import nms as nms_cuda

        self.module, self.limit, self.calls = nms_cuda, limit, []

    def __enter__(self):
        inner = self.orig = self.module.nms_mask_sorted_cuda

        def wrapped(boxes, valid, iou_thr):
            if len(self.calls) < self.limit:
                self.calls.append((boxes.clone(), valid.clone(), float(iou_thr)))
            return inner(boxes, valid, iou_thr)

        self.module.nms_mask_sorted_cuda = wrapped
        return self

    def __exit__(self, *exc):
        self.module.nms_mask_sorted_cuda = self.orig


def phase_nms_proposals(sets: dict) -> dict:
    """K2 on the problems the main paths handed it ({name: (boxes, valid,
    IoU threshold)}, captured from the first Faster R-CNN inference batch
    and the first training step): bit for bit against its plain version,
    timed, with its bound and the shares of rows kept and of tested pairs
    that do not intersect."""
    return {name: k2_case(name, thr, boxes, valid)
            for name, (boxes, valid, thr) in sets.items()}


def phase_roi_align_bwd_train(device, cap: dict, k3: dict, k1: dict) -> None:
    """K3 and K1 on the rois of one Faster R-CNN training step (captured
    from the train path's first step), as ``k3_on_rois`` and ``k1_on_rois``
    check them, K1 in the step's dtype."""
    k3["train_step"] = k3_on_rois(device, cap, "one training step's rois", seed=17)
    dtype = cap["g"][1]
    k1["train_step"] = k1_on_rois(device, cap, "the training step's rois", (dtype,),
                                  seed=18)[str(dtype).replace("torch.", "")]


def k3_on_rois(device, cap: dict, what: str, seed: int) -> dict:
    """K3 on captured rois (a ``CaptureRoi`` record) with a seeded
    upstream gradient of the captured shape and dtype: f32 within 1e-5 of
    the largest value of autograd of the plain version, bf16 equal to the
    f32 gradient rounded; the pairs, the longest list and the pairs read
    from g; timed in bf16."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_bwd_cuda

    shape, dtype = cap["g"]
    p = shape[2]
    tag = f"K3 P={p}"
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device, dtype)
    shapes, strides = cap["shapes"], cap["strides"]
    rois, levels, valid = cap["rois"], cap["levels"], cap["roi_valid"]
    facts = k3_stage_facts(shapes, strides, rois, levels, valid, p, g)
    leaves = [torch.zeros((g.shape[0], h, w, g.shape[-1]), device=device, requires_grad=True)
              for h, w in shapes]
    out = ra.multilevel_roi_align_plain(leaves, rois, strides, levels, output_size=p,
                                        roi_valid=valid)
    ref = torch.autograd.grad(out, leaves, g.float())
    run = lambda dtype: roi_align_bwd_cuda(g, shapes, rois, strides, levels,  # noqa: E731
                                           roi_valid=valid, out_dtype=dtype)
    f32 = run(torch.float32)
    scale = max(x.abs().max().item() for x in ref)
    max_abs = max((a - e).abs().max().item() for a, e in zip(f32, ref))
    rounded = all(torch.equal(x, a.to(torch.bfloat16)) for x, a in zip(run(torch.bfloat16), f32))
    ms = time_ms(lambda: run(torch.bfloat16))
    log(f"{tag} on {what} ({int(valid.sum())} valid of {tuple(valid.shape)}, rois a level "
        f"{torch.bincount(levels[valid].long(), minlength=len(shapes)).tolist()}, g "
        f"{g.dtype}): {facts['pairs']} (roi, tile) pairs, longest list {facts['longest_list']}, "
        f"{facts['unstaged_pairs']} pairs of {facts['unstaged_rois']} rois read from g; f32 "
        f"max_abs_err {max_abs:.3e} of max|ref| {scale:.3e}; bf16 = f32 rounded: {rounded}; "
        f"bf16 {ms:.4f} ms")
    if max_abs > 1e-5 * scale or not rounded:
        fail(f"{tag} on {what} disagrees with autograd of the plain RoIAlign")
    return {"ms": ms, "max_abs_err": max_abs, **facts,
            "rois": {"rois": rois.cpu(), "levels": levels.cpu(), "valid": valid.cpu()}}


def k1_on_rois(device, cap: dict, what: str, dtypes, seed: int) -> dict:
    """K1 at the captured output size on captured rois with seeded features
    of the captured channels, in each of ``dtypes``, held against its plain
    version (``k1_check``) and timed -> {dtype name: record}."""
    import torch

    from mxdetection_tpu_torch.ops import roi_align as ra
    from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_cuda

    shape = cap["g"][0]
    b, p, c = shape[0], shape[2], shape[-1]
    tag = f"K1 P={p}"
    shapes, strides = cap["shapes"], cap["strides"]
    rois, levels, valid = cap["rois"], cap["levels"], cap["roi_valid"]
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for dtype in dtypes:
        feats = [torch.randn((b, h, w, c), generator=gen).to(device, dtype) for h, w in shapes]
        fwd = lambda: roi_align_cuda(feats, rois, strides, levels,  # noqa: E731
                                     output_size=p, roi_valid=valid)
        ok, err, rule = k1_check(fwd(), ra.multilevel_roi_align_plain(
            feats, rois, strides, levels, output_size=p, roi_valid=valid), valid, dtype)
        ms = time_ms(fwd)
        log(f"{tag} on {what} ({dtype} features): max_abs_err {err:.3e} ({rule}: "
            f"{'ok' if ok else 'FAILED'}); {ms:.4f} ms")
        if not ok:
            fail(f"{tag} on {what} disagrees with its plain version in {dtype}")
        out[str(dtype).replace("torch.", "")] = {"ms": ms, "max_abs_err": err}
    return out


# --------------------------------------------------------------------------
# phase 6: inference path


# Seeded random weights score every class near its prior: RetinaNet's sigmoid
# scores lie in 0.0099-0.013 (its prior bias), R-FCN's softmax within 0.002 of
# 1/81 (seed 0, 256x320, f32, on the CPU): under the test threshold of 0.05
# and, among thousands of candidates, closer to each other than the card's
# and the CPU's rounding. Their class convs' weights are scaled, so that the
# scores spread as a trained net's (there, RetinaNet's top 40 lie in
# 0.65-0.81 and R-FCN's in 0.69-0.88).
CLASS_CONV_SCALE = {"retinanet": ("head.cls_score", 30.0), "rfcn": ("rfcn_cls", 100.0)}


def seeded_model(cfg, device, train: bool = False):
    """``build_detector(cfg, seed=0)`` on ``device``, its class conv scaled
    by ``CLASS_CONV_SCALE`` where the config has one."""
    import torch

    from mxdetection_tpu_torch.models.registry import build_detector

    model = build_detector(cfg, device=device, seed=0, train=train)
    if cfg.detector in CLASS_CONV_SCALE:
        name, k = CLASS_CONV_SCALE[cfg.detector]
        with torch.no_grad():
            model.get_submodule(name).weight.mul_(k)
    return model


def detect(model, cfg, raw, hw, dtype, masks: bool = True):
    """One batch: ``batch_transform``, ``forward_test``, the detector's
    postprocess (``detector_fns``: ``rcnn_postprocess`` or
    ``retinanet_postprocess``) and, for a model with a mask head unless
    ``masks`` is false, ``mask_probs`` (``dets["masks"]``). Returns (dets,
    outputs); the outputs keep the batch's ``im_info``."""
    import torch

    from mxdetection_tpu_torch.data.transforms import batch_transform
    from mxdetection_tpu_torch.models.detectors.rcnn import mask_probs
    from mxdetection_tpu_torch.models.registry import detector_fns

    d = cfg.data
    pad_hw = (d.pad_h, d.pad_w)
    b = raw.shape[0]
    flip = torch.zeros((b,), dtype=torch.bool, device=raw.device)
    gtb = torch.zeros((b, d.max_gt, 4), device=raw.device)
    with torch.no_grad():
        tb = batch_transform(raw, hw, flip, gtb, out_hw=pad_hw, scale_size=d.scale,
                             max_size=d.max_size, mean=d.mean, std=d.std, dtype=dtype)
        out = model.forward_test(tb["images"], tb["im_info"])
        out["im_info"] = tb["im_info"]
        dets = detector_fns(cfg).postprocess(out, cfg, pad_hw, tb["im_info"])
        if masks and getattr(model, "mask_head", None) is not None:
            dets["masks"] = mask_probs(model, out, dets, tb["im_info"])
        return dets, out


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
    if "masks" in dets:
        m = dets["masks"]
        if m.shape != (*v.shape, 28, 28) or not ((m >= 0) & (m <= 1)).all():
            fail(f"{what}: mask probabilities of shape {tuple(m.shape)}, not all in [0, 1]")
    return n_valid


SMALL_OVERRIDES = {
    "data.pad_h": 256, "data.pad_w": 320, "data.scale": 240, "data.max_size": 320,
    "backbone.dtype": "float32", "test.max_per_image": 20,
    "rpn.pre_nms_top_n_test": 400, "rpn.post_nms_top_n_test": 100,
    "test.pre_nms_per_class": 200}


def small_input():
    """Two uint8 canvases for the card-vs-CPU checks, and their (h, w)."""
    import torch

    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (2, 240, 300, 3), generator=gen, dtype=torch.uint8)
    return raw, torch.tensor([[240.0, 300.0], [200.0, 300.0]])


def check_parity(cpu, gpu, hw, what: str) -> None:
    """The card's detections against the CPU port's: same valid and labels,
    boxes within 1e-2 px and scores within 1e-4, and mask probabilities
    (where there are) within 1e-3."""
    import torch

    gpu = {k: v.cpu() for k, v in gpu.items()}
    n = check_dets(gpu, hw, f"{what} on the card")
    same_valid = torch.equal(cpu["valid"], gpu["valid"])
    box_err = (cpu["boxes"] - gpu["boxes"]).abs().max().item()
    score_err = (cpu["scores"] - gpu["scores"]).abs().max().item()
    same_labels = torch.equal(cpu["labels"], gpu["labels"])
    mask_err = (cpu["masks"] - gpu["masks"]).abs().max().item() if "masks" in cpu else 0.0
    log(f"{what} card vs CPU: {n} valid, same valid {same_valid}, same labels "
        f"{same_labels}, max box err {box_err:.3e}, max score err {score_err:.3e}"
        + (f", max mask probability err {mask_err:.3e}" if "masks" in cpu else "")
        + " (bound 1e-2 px, 1e-4" + (", 1e-3)" if "masks" in cpu else ")"))
    if not (same_valid and same_labels and box_err <= 1e-2 and score_err <= 1e-4
            and mask_err <= 1e-3):
        fail(f"{what}: card detections differ from the CPU port's")


def small_parity(device, name: str = "faster_rcnn_r50_fpn_1x",
                 what: str = "small f32 input") -> None:
    """A 256x320 f32 input through the port on the card (kernels) and on the
    CPU (plain versions, which the CPU tests hold against the JAX package),
    with the mask probabilities where the config has a mask head; the seeded
    weights as ``seeded_model`` makes them."""
    import torch

    from mxdetection_tpu_torch.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(name).override(**SMALL_OVERRIDES)
    raw, hw = small_input()
    dets = {}
    for dev in ("cpu", device):
        model = seeded_model(cfg, "cpu").to(dev)
        dets[dev] = detect(model, cfg, raw.to(dev), hw.to(dev), torch.float32)[0]
    check_parity(dets["cpu"], dets[device], hw, what)


def drive(model, cfg, raw, hw, dtype, counters, card: str, what: str) -> tuple:
    """A warm-up batch and ``TIMED_BATCHES`` timed ones of ``model`` (each
    with its mask probabilities where it has a mask head), every launch
    count set to 0 just before and read just after; fails if a counted
    kernel was never launched or the detections are wrong.
    Returns (launches, dets, outputs, ms per batch)."""
    import torch

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets, out = detect(model, cfg, raw, hw, dtype)  # warm-up
    torch.cuda.synchronize()
    log(f"{what} warm-up batch: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    times = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        dets, out = detect(model, cfg, raw, hw, dtype)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {c.name: c.n for c in counters}
    n_valid = check_dets({k: v.cpu() for k, v in dets.items()}, hw.cpu(), what)
    for name, n in launches.items():
        if n == 0:
            fail(f"{what} never launched the {name} kernel")
    log(f"{what} ms per batch ({card}): " + ", ".join(f"{ms:.2f}" for ms in times))
    q = torch.tensor(times).quantile(torch.tensor([0.25, 0.5, 0.75])).tolist()
    log(f"{what}: {TIMED_BATCHES} batches of {MAIN_BATCH}x832x1344 bf16, ms per batch: "
        f"p25 {q[0]:.2f}, median {q[1]:.2f}, p75 {q[2]:.2f}, max {max(times):.2f}; "
        f"median {MAIN_BATCH * 1e3 / q[1]:.1f} images/s ({card})")
    log(f"{what}: "
        + (f"{int(out['roi_valid'].sum())}/{out['roi_valid'].numel()} valid proposals, "
           if "roi_valid" in out else "")
        + (f"pyramid max |P| {max(p.abs().max().item() for p in out['pyramid']):.1f}, "
           if "pyramid" in out else "")
        + f"{n_valid} valid detections in the last batch; launches {launches}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, dets, out, times


def phase_main_path(device, card: str, counters, profile_dir: str | None,
                    nms_capture: CaptureNms) -> dict:
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
    with nms_capture:
        launches = drive(model, cfg, raw, hw, dtype, counters, card, "main path")[0]
    if profile_dir is not None:
        phase_profile(model, cfg, raw, hw, dtype, profile_dir)
    return launches


# --------------------------------------------------------------------------
# optional phase 5 (--profile DIR): where the main path's time goes


def stage_breakdown(model, cfg, raw, hw, dtype, reps: int) -> dict:
    """Mean device-timeline ms of each stage of a main-path batch, split at
    the module boundaries by CUDA events recorded from forward hooks (with
    a mask head, the mask branch after the postprocess: its RoIAlign, the
    head, the class slice and sigmoid). A stage's time includes any device
    idle time inside it."""
    import torch

    from mxdetection_tpu_torch.models.detectors.rcnn import mask_probs

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
    ]
    n = model.num_stages
    for i in range(n):  # a cascade stage: (decode of the last +) RoIAlign, then its head
        before = "proposals + roi_align" if i == 0 else f"decode{i - 1} + roi_align{i}"
        after = "bbox_head" if n == 1 else f"bbox_head{i}"
        hooks += [
            model.bbox_head(i).register_forward_pre_hook(lambda *_, b=before: mark(b)),
            model.bbox_head(i).register_forward_hook(lambda *_, a=after: mark(a)),
        ]
    if model.mask_head is not None:
        hooks += [
            model.mask_head.register_forward_pre_hook(lambda *_: mark("mask roi_align")),
            model.mask_head.register_forward_hook(lambda *_: mark("mask_head")),
        ]
    totals = {}
    try:
        for _ in range(reps):
            marks.clear()
            mark("start")
            dets, out = detect(model, cfg, raw, hw, dtype, masks=False)
            mark("rcnn_postprocess")
            if model.mask_head is not None:
                mask_probs(model, out, dets, out["im_info"])
                mark("mask class slice + sigmoid")
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
    # the device time of the kernels each op launched, itself or through the
    # ops it called (so nested ops count twice: an autograd node's total
    # holds its matmuls' too)
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU
                  and e.device_time_total > 0 and not e.key.startswith("ProfilerStep")),
                 key=lambda e: e.device_time_total, reverse=True)
    for e in ops[:15]:
        ms = e.device_time_total / 1e3 / reps
        log(f"profile {label} op {ms:8.3f} ms {e.count // reps:6d} calls  {e.key[:90]}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    log(f"profile {label}: trace written to {path}")


def phase_profile(model, cfg, raw, hw, dtype, out_dir: str, label: str = "main_path") -> None:
    import os

    stages = stage_breakdown(model, cfg, raw, hw, dtype, reps=5)
    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"profile {label} stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
    trace(lambda: detect(model, cfg, raw, hw, dtype), 2, f"{label} batch",
          os.path.join(out_dir, f"{label}_trace.json.gz"))


# --------------------------------------------------------------------------
# phase 7: K5 + K5b


def dcn_bound(b: int, h: int, w: int, c: int, stride: int, dtype) -> tuple[float, str]:
    """x, offsets and W read once, the output written once; the product's
    2 * M * 9 * C * C operations on the tensor cores (bf16) or the f32
    units, and the blend's 7 f32 operations per sampled value."""
    import torch

    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = b * h * w * c * size + m * 18 * 4 + 9 * c * c * size + m * c * size
    gemm, blend = 2.0 * m * 9 * c * c, 7.0 * m * 9 * c
    if dtype == torch.bfloat16:
        return bound(nbytes, blend, gemm)
    return bound(nbytes, blend + gemm)


def sample_stats(offsets, h: int, w: int, stride: int, dilation: int) -> dict:
    """Of offsets (B, Ho, Wo, 18): the counts of values, of values beyond
    +-3 cells, of taps, and of taps whose sample point lies outside the map
    [0, H-1] x [0, W-1] (so that at least one corner weighs zero)."""
    import torch

    b, ho, wo = offsets.shape[:3]
    off = offsets.float().reshape(b, ho, wo, 3, 3, 2)
    dev = offsets.device
    tap = torch.arange(3, device=dev, dtype=torch.float32) * dilation - dilation
    sy = (torch.arange(ho, device=dev) * stride)[:, None, None, None] + tap[:, None] + off[..., 0]
    sx = (torch.arange(wo, device=dev) * stride)[None, :, None, None] + tap + off[..., 1]
    out = (sy < 0) | (sy > h - 1) | (sx < 0) | (sx > w - 1)
    return {"values": off.numel(), "beyond3": int((off.abs() > 3).sum()),
            "taps": out.numel(), "taps_out": int(out.sum()),
            "sq": float((off.double() ** 2).sum()), "max": float(off.abs().max())}


def merge_stats(total: dict, part: dict) -> dict:
    return {k: (max(total.get(k, 0.0), v) if k == "max" else total.get(k, 0) + v)
            for k, v in part.items()}


def describe_stats(st: dict) -> str:
    return (f"offset std {(st['sq'] / st['values']) ** 0.5:.3f} cells, max |offset| "
            f"{st['max']:.2f}, {100 * st['beyond3'] / st['values']:.2f}% beyond +-3, "
            f"{100 * st['taps_out'] / st['taps']:.2f}% of taps sample outside the map")


def ptxas_facts(name: str, tag: str) -> dict:
    """Log ptxas's lines (registers, spills, shared memory) of kernel
    ``name`` (every instantiation) and fail on spills; -> {instantiation:
    its SASS} by ``cuobjdump``."""
    import os
    import re

    from mxdetection_tpu_torch.ops.cuda import build

    path, _, report = build.build()
    lines, keep = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = name in line
        if keep:
            lines.append(line.strip())
    for line in lines:
        log(f"{tag} ptxas: {line}")
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                            "\n".join(lines)))
    if not lines:
        fail(f"{tag}: no ptxas report of {name}")
    if spills:
        fail(f"{tag}: {name} spills {spills} bytes")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = func.split("\n", 1)[0].strip()
        if name in fname:
            funcs[fname] = func
    return funcs


def k5_build_facts() -> None:
    """Log what nvcc made of the bf16 K5 kernel (``deform_conv_fwd_kernel``,
    one instantiation a tile width): ptxas's lines (registers, spills), its
    dynamic shared memory and the count of ``HGMMA`` (wgmma) instructions in
    its SASS by ``cuobjdump``; fail on spills or on a kernel without wgmma."""
    from mxdetection_tpu_torch.ops.cuda import build

    name = "deform_conv_fwd_kernel"
    funcs = ptxas_facts(name, "K5")
    lib = build.load_library()
    smem = {cout: lib.mxdet_deform_conv_fwd_smem(cout) for cout in (128, 256, 512)}
    log(f"K5 bf16 dynamic shared memory a block by Cout: {smem} bytes")
    if min(smem.values()) <= 48 * 1024:
        fail("K5: the bf16 kernel's ring should take more than 48 KB of shared memory")
    hgmma = {fname: func.count("HGMMA") for fname, func in funcs.items()}
    log(f"K5 SASS (cuobjdump): HGMMA instructions by instantiation {hgmma}")
    if not hgmma or not all(hgmma.values()):
        fail(f"K5: no HGMMA in the SASS of {name}")


def k6_build_facts(device) -> None:
    """Log what nvcc made of the bf16 K6 kernel (``wgrad_kernel``, one
    instantiation a tile width): ptxas's lines (registers, spills), the count
    of ``HGMMA`` (wgmma) instructions in its SASS, failing on spills or on a
    kernel without wgmma; and the partition the built kernel reports at the
    six DCN layer shapes (``wgrad_layout_cuda``), failing where it is not
    the plain model's (``wgrad_config``, read from the source)."""
    import torch

    from mxdetection_tpu_torch.ops.cuda.deform_conv import wgrad_config, wgrad_layout_cuda

    name = "wgrad_kernel"
    funcs = ptxas_facts(name, "K6")
    hgmma = {fname: func.count("HGMMA") for fname, func in funcs.items()}
    log(f"K6 SASS (cuobjdump): HGMMA instructions by instantiation {hgmma}")
    if len(hgmma) < 2 or not all(hgmma.values()):
        fail(f"K6: no HGMMA in the SASS of {name} (both tile widths)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for stage, h, w, c, stride, _ in DCN_LAYERS:
        m = MAIN_BATCH * -(-h // stride) * -(-w // stride)
        for bf16 in (True, False):
            built, model = wgrad_layout_cuda(c, c, m, sms, bf16), wgrad_config(c, c, m, sms=sms,
                                                                                bf16=bf16)
            same = all(built[k] == v for k, v in model.items())
            log(f"K6 {stage} s{stride} {'bf16' if bf16 else 'f32'} ({sms} SMs): built kernel "
                f"{built} (smem: dynamic shared memory a block, bytes), plain model {model}: "
                f"{'same' if same else 'DIFFERENT'}")
            if not same:
                fail(f"K6 {stage} s{stride}: the built kernel's partition is not the plain model's")


def k7_build_facts() -> None:
    """Log what nvcc made of K7/K7b (``deform_col2im_kernel``, one
    instantiation a dtype and stride): ptxas's lines, failing on spills; the
    tile, window and shared memory the built kernel reports
    (``col2im_layout_cuda``), failing where they differ from the plain
    model's (``col2im_config``, read from the source); and its SASS's
    atomics."""
    import re

    from mxdetection_tpu_torch.ops.cuda.deform_conv import col2im_config, col2im_layout_cuda

    funcs = ptxas_facts("deform_col2im_kernel", "K7")
    for stride in (1, 2):
        model = col2im_config(stride)
        for dt in ("bf16", "f32"):
            built = col2im_layout_cuda(stride, dt == "bf16")
            same = all(built[k] == model[k] for k in ("tile", "chunk", "origin", "window"))
            log(f"K7 s{stride} {dt}: built kernel {built} (smem: dynamic shared memory a "
                f"block, bytes), plain model {model}: {'same' if same else 'DIFFERENT'} window")
            if not same:
                fail(f"K7 s{stride} {dt}: the built kernel's window is not the plain model's")
    for fname, func in funcs.items():
        ops = sorted(set(re.findall(r"\b(?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Za-z0-9_.]+", func)))
        log(f"K7 SASS (cuobjdump) {fname}: atomics {ops}")


def phase_deform_conv(device) -> dict:
    """K5 (stride 1) and K5b (stride 2) against the plain version at the six
    DCN layer shapes of the cascade path, batch 8, offsets of std 1.5 cells."""
    import torch
    import torch.nn.functional as F

    from mxdetection_tpu_torch.ops.cuda.deform_conv import (bf16_tile_n, deform_conv2d_cuda,
                                                            wgmma_weight_tiles,
                                                            wgmma_weight_tiles_cuda)
    from mxdetection_tpu_torch.ops.dcn import deform_conv2d

    def bf16_ok(got, ref) -> tuple[bool, float]:
        """Within two bf16 roundings of |ref| plus 1e-4 of max|ref|."""
        err = (got.float() - ref.float()).abs()
        tol = 2.0 ** -7 * ref.float().abs() + 1e-4 * ref.float().abs().max()
        return bool((err <= tol).all()) and bool(torch.isfinite(got).all()), err.max().item()

    k5_build_facts()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(10)
    b = MAIN_BATCH
    res = {stride: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0, "bound_ms_by": {"bytes": 0.0, "operations": 0.0},
                    "by_shape": {}} for stride in (1, 2)}
    for stage, h, w, c, stride, n in DCN_LAYERS:
        ho, wo = -(-h // stride), -(-w // stride)
        x32 = torch.randn((b, h, w, c), generator=gen).to(device)
        off = (torch.randn((b, ho, wo, 18), generator=gen) * 1.5).to(device)
        w32 = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).to(device)
        st = sample_stats(off, h, w, stride, 1)
        shape = f"{stage} s{stride} {h}x{w}x{c}"
        ref = deform_conv2d(x32, off, w32, stride=stride)
        got = deform_conv2d_cuda(x32, off, w32, stride=stride)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err32 = (got - ref).abs().max().item()
        x16, w16 = x32.bfloat16(), w32.bfloat16()
        ref16 = deform_conv2d(x16, off, w16, stride=stride).float()
        got16 = deform_conv2d_cuda(x16, off, w16, stride=stride).float()
        torch.cuda.synchronize()
        err16 = (got16 - ref16).abs()
        ok16 = bool((err16 <= 2.0 ** -7 * ref16.abs() + 1e-4 * scale).all())
        if not (torch.isfinite(got).all() and torch.isfinite(got16).all()):
            fail(f"K5 {shape}: non-finite output")
        kernel = lambda: deform_conv2d_cuda(x16, off, w16, stride=stride)
        plain = lambda: deform_conv2d(x16, off, w16, stride=stride)
        xc = x16.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        wc = w16.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library = lambda: F.conv2d(xc, wc, stride=stride, padding=1)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        ms, library_ms = time_ms(kernel), time_ms(library)
        plain_ms = (plain_ms + time_ms(plain, reps=3, warmup=1)) / 2
        f32_ms = time_ms(lambda: deform_conv2d_cuda(x32, off, w32, stride=stride), reps=3)
        bound_ms, bound_by = dcn_bound(b, h, w, c, stride, torch.bfloat16)
        log(f"K5{'b' if stride == 2 else ''} deform_conv {shape} -> {ho}x{wo}, x{n} a batch: "
            f"f32 max_abs_err {err32:.3e} of max|ref| {scale:.3e} (<= 1e-4 max|ref|: "
            f"{'ok' if err32 <= 1e-4 * scale else 'FAILED'}), bf16 max_abs_err "
            f"{err16.max().item():.3e} (|err| <= 2^-7 |ref| + 1e-4 max|ref|: "
            f"{'ok' if ok16 else 'FAILED'}); bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.conv2d {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); f32 kernel "
            f"{f32_ms:.4f} ms (bound {dcn_bound(b, h, w, c, stride, torch.float32)[0]:.4f}); "
            f"{describe_stats(st)}")
        if err32 > 1e-4 * scale or not ok16:
            fail(f"K5 disagrees with its plain version at {shape}")
        if not torch.equal(wgmma_weight_tiles_cuda(w16), wgmma_weight_tiles(w16, bf16_tile_n(c))):
            fail(f"K5 {shape}: the card's weight tiles differ from wgmma_weight_tiles")
        r = res[stride]
        r["max_abs_err"] = max(r["max_abs_err"], err32)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                     ("library_ms", library_ms)):
            r[k] += n * v  # per batch of the cascade path
        r["bound_ms_by"][bound_by] += n * bound_ms
        r["bound_by"] = max(r["bound_ms_by"], key=r["bound_ms_by"].get)
        r["by_shape"][shape] = {"layers": n, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": library_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "f32_ms": f32_ms, "f32_max_abs_err": err32}
        del x32, off, w32, ref, got, x16, w16, ref16, got16, err16

    # radius 3 (the Pallas kernels' clamp), dilation 2 and zero offsets, in f32
    x = torch.randn((b, 52, 84, 256), generator=gen).to(device)
    off = (torch.randn((b, 52, 84, 18), generator=gen) * 1.5).to(device)
    wt = (torch.randn((3, 3, 256, 256), generator=gen) * (2.0 / (9 * 256)) ** 0.5).to(device)
    checks = [("radius 3", deform_conv2d_cuda(x, off, wt, radius=3),
               deform_conv2d(x, off, wt, radius=3))]
    zero = torch.zeros_like(off)
    conv = F.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1)
    checks.append(("zero offsets vs F.conv2d", deform_conv2d_cuda(x, zero, wt),
                   conv.permute(0, 2, 3, 1)))
    xs = torch.randn((2, 20, 24, 128), generator=gen).to(device)
    ws = (torch.randn((3, 3, 128, 128), generator=gen) * 0.03).to(device)
    for stride in (1, 2):
        offs = (torch.randn((2, -(-20 // stride), -(-24 // stride), 18), generator=gen)
                * 1.5).to(device)
        checks.append((f"dilation 2 stride {stride}",
                       deform_conv2d_cuda(xs, offs, ws, stride=stride, dilation=2),
                       deform_conv2d(xs, offs, ws, stride=stride, dilation=2)))
    torch.cuda.synchronize()
    for what, got, ref in checks:
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        log(f"K5 {what} (f32): max_abs_err {err:.3e} of max|ref| {scale:.3e} "
            f"(<= 1e-4 max|ref|: {'ok' if err <= 1e-4 * scale else 'FAILED'})")
        if not err <= 1e-4 * scale:
            fail(f"K5 {what}: disagrees with its reference")

    # bf16: zero offsets against cuDNN's bf16 conv at the stage-3 and stage-4
    # shapes (stage 4's M = 8 x 26 x 42 is no multiple of the 64-row tile),
    # and a ragged M at both strides (2 x 19 x 23 and 2 x 10 x 12 pixels)
    checks = []
    for h, w, c in ((52, 84, 256), (26, 42, 512)):
        x16 = torch.randn((b, h, w, c), generator=gen).to(device).bfloat16()
        w16 = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).to(device)
        w16 = w16.bfloat16()
        conv = F.conv2d(x16.permute(0, 3, 1, 2), w16.permute(3, 2, 0, 1), padding=1)
        checks.append((f"zero offsets vs F.conv2d {h}x{w}x{c}",
                       deform_conv2d_cuda(x16, torch.zeros((b, h, w, 18), device=device), w16),
                       conv.permute(0, 2, 3, 1)))
    xs16 = torch.randn((2, 19, 23, 128), generator=gen).to(device).bfloat16()
    ws16 = ws.bfloat16()
    for stride in (1, 2):
        offs = (torch.randn((2, -(-19 // stride), -(-23 // stride), 18), generator=gen)
                * 1.5).to(device)
        checks.append((f"ragged M 2x19x23x128 stride {stride}",
                       deform_conv2d_cuda(xs16, offs, ws16, stride=stride),
                       deform_conv2d(xs16, offs, ws16, stride=stride)))
    torch.cuda.synchronize()
    for what, got, ref in checks:
        ok, err = bf16_ok(got, ref)
        log(f"K5 {what} (bf16): max_abs_err {err:.3e} of max|ref| "
            f"{ref.float().abs().max().item():.3e} (|err| <= 2^-7 |ref| + 1e-4 max|ref|: "
            f"{'ok' if ok else 'FAILED'})")
        if not ok:
            fail(f"K5 {what} (bf16): disagrees with its reference")
    return res


# --------------------------------------------------------------------------
# phase 8: the Cascade R-CNN R101-DCN inference path


def dcn_layers(model) -> list:
    from mxdetection_tpu_torch.models.backbones.resnet import DeformConv

    return [m for m in model.modules() if isinstance(m, DeformConv)]


def seed_offset_convs(model, cfg, raw, hw, gen) -> None:
    """Overwrite every offset conv's weight (zero in the JAX init, which
    would make each DCN a plain conv) with seeded normal noise scaled by
    1 / (sqrt(9 Cin) * RMS of the layer's input), so that its offsets have
    a std of about 1 cell. The RMS is measured layer by layer in one f32
    forward pass of ``raw`` (each layer's input depends on the offsets
    before it)."""
    import torch

    def pre(m, args):
        rms = args[0].float().pow(2).mean().sqrt()
        w = m.offset_conv.weight
        noise = torch.randn(w.shape, generator=gen).to(w.device)
        with torch.no_grad():
            w.copy_(noise / (rms * (9 * w.shape[1]) ** 0.5))

    hooks = [m.register_forward_pre_hook(pre) for m in dcn_layers(model)]
    try:
        detect(model, cfg, raw, hw, torch.float32)
    finally:
        for h in hooks:
            h.remove()


def offset_stats(model, run) -> dict:
    """Sample statistics of every DCN layer's offsets over one ``run()``."""
    total = {}

    def post(dcn, args, out):
        nonlocal total
        h, w = args[0].shape[2:]
        total = merge_stats(total, sample_stats(out.permute(0, 2, 3, 1), h, w, dcn.stride,
                                                dcn.dilation))

    hooks = [m.offset_conv.register_forward_hook(
        lambda _, args, out, dcn=m: post(dcn, args, out)) for m in dcn_layers(model)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total


def phase_cascade_path(device, card: str, counters, profile_dir: str | None) -> dict:
    """Cascade R-CNN R101-DCN inference: seed 0 weights whose offset convs
    are calibrated on the main batch (in f32), the card-vs-CPU check on a
    small f32 input with those weights, then 8x832x1344 bf16 batches."""
    import copy

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector

    torch.backends.cudnn.allow_tf32 = False  # the card-vs-CPU check is in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(CASCADE)
    small = cfg.override(**SMALL_OVERRIDES)
    t0 = time.perf_counter()
    cpu_model = build_detector(small, device="cpu", seed=0)
    log(f"cascade path: {cfg.name}, seeded init in {time.perf_counter() - t0:.1f} s, "
        f"{len(dcn_layers(cpu_model))} DCN layers")
    gen = torch.Generator().manual_seed(12)
    raw = torch.randint(0, 256, (MAIN_BATCH, 480, 640, 3), generator=gen,
                        dtype=torch.uint8).to(device)
    hw = torch.tensor([[480.0, 640.0]] * MAIN_BATCH, device=device)
    gpu_model = copy.deepcopy(cpu_model).to(device)
    seed_offset_convs(gpu_model, cfg, raw, hw, torch.Generator().manual_seed(11))
    state = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    cpu_model.load_state_dict(state)

    small_raw, small_hw = small_input()
    st = offset_stats(gpu_model, lambda: detect(gpu_model, small, small_raw.to(device),
                                                small_hw.to(device), torch.float32))
    log(f"cascade small f32 input: {describe_stats(st)}")
    t0 = time.perf_counter()
    dets_cpu = detect(cpu_model, small, small_raw, small_hw, torch.float32)[0]
    log(f"cascade small f32 input on the CPU: {time.perf_counter() - t0:.1f} s")
    dets_gpu = detect(gpu_model, small, small_raw.to(device), small_hw.to(device),
                      torch.float32)[0]
    check_parity(dets_cpu, dets_gpu, small_hw, "cascade small f32 input (cuDNN and matmul TF32 "
                 "off)")
    del cpu_model, gpu_model

    dtype = getattr(torch, cfg.backbone.dtype)
    model = build_detector(cfg, device=device)  # bf16, offset convs f32
    model.load_state_dict(state)  # the seeded weights above, cast where stored in bf16
    st = offset_stats(model, lambda: detect(model, cfg, raw, hw, dtype))
    log(f"cascade path, one batch of {MAIN_BATCH}x832x1344: {describe_stats(st)}")
    launches = drive(model, cfg, raw, hw, dtype, counters, card, "cascade path")[0]
    per_batch = {k: n / (TIMED_BATCHES + 1) for k, n in launches.items()}
    log(f"cascade path: launches per batch {per_batch}")
    if per_batch.get("deform_conv") != 27 or per_batch.get("deform_conv_s2") != 3:
        fail(f"cascade path: expected 27 K5 and 3 K5b launches a batch, got {per_batch}")
    if profile_dir is not None:
        phase_profile(model, cfg, raw, hw, dtype, profile_dir, label="cascade_path")
    return launches


# --------------------------------------------------------------------------
# phase 9: training path


def train_batch(b: int, raw_hw, gen, device) -> dict:
    """``b`` uint8 canvases with 3 to 11 gt boxes each (the COCO mean is
    about 7), padded to 100 rows, half of the images flipped, and each
    row's box mask (Mask R-CNN's; the other detectors' steps leave it),
    drawn last: a filled ellipse of random centre and radii in the gt-box
    frame, uint8 (b, 100, 28, 28)."""
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
    centre = torch.rand((b, 100, 2, 1, 1), generator=gen) * 12 + 8
    radii = torch.rand((b, 100, 2, 1, 1), generator=gen) * 8 + 5
    ij = torch.arange(28.0) + 0.5
    d = ((ij[:, None] - centre[:, :, 0]) / radii[:, :, 0]) ** 2 + (
        (ij[None, :] - centre[:, :, 1]) / radii[:, :, 1]) ** 2
    batch["box_masks"] = (d <= 1.0).to(torch.uint8)
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
    """The gradient's norm in each top-level module of ``model`` that has
    parameters (the JAX fixtures' ``gnorm_<module>``)."""
    import torch

    out = {}
    for mod, m in model.named_children():
        gs = [p.grad.double() for p in m.parameters() if p.grad is not None]
        if any(True for _ in m.parameters()):
            out[f"gnorm_{mod}"] = float(torch.sqrt(sum((g * g).sum() for g in gs)))
    return out


SMALL_TRAIN_OVERRIDES = {
    "data.pad_h": 256, "data.pad_w": 320, "data.scale": 240, "data.max_size": 320,
    "data.max_gt": 8, "backbone.dtype": "float32", "bbox_head.num_samples": 32,
    "rpn.pre_nms_top_n_train": 400, "rpn.post_nms_top_n_train": 100}


def small_train_step(cfg, state: dict, batch: dict, draws, device, what: str) -> tuple:
    """One training step of ``cfg`` on ``device`` from the weights
    ``state``: (its metrics and per-module grad norms, the norms' running
    statistics after it, on the CPU)."""
    from mxdetection_tpu_torch.models.registry import build_detector
    from mxdetection_tpu_torch.train.trainer import Trainer

    m = build_detector(cfg, device="cpu", train=True)
    m.load_state_dict(state)
    t0 = time.perf_counter()
    metrics = Trainer(cfg, m, device=device).run_step(batch, draws=draws)
    res = {**{k: float(v) for k, v in metrics.items()}, **grad_norms(m)}
    log(f"{what} on {device}: {time.perf_counter() - t0:.1f} s")
    stats = {k: v.detach().cpu() for k, v in m.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return res, stats


def small_train_parity(device, name: str = "faster_rcnn_r50_fpn_1x", state=None,
                       what: str = "small f32 train step", overrides=None) -> tuple:
    """One f32 training step at 256x320, batch 2, on the card (kernels) and
    on the CPU (plain versions, which the CPU tests hold against the JAX
    package), from the same weights (``seeded_model``'s, or ``state``) and
    the same random draws, the config overridden by ``SMALL_TRAIN_OVERRIDES``
    and then ``overrides``. Returns what ``check_remat`` needs to repeat the
    card's step."""
    import torch

    from mxdetection_tpu_torch.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(name, {**SMALL_TRAIN_OVERRIDES, **(overrides or {})})
    batch = train_batch(2, (240, 300), torch.Generator().manual_seed(7), "cpu")
    batch = {k: v[:, :8] if k.startswith("gt_") or k == "box_masks" else v
             for k, v in batch.items()}
    replay = ReplayDraws(8)
    if state is None:
        model = seeded_model(cfg, "cpu", train=True)
        state = {k: v.clone() for k, v in model.state_dict().items()}
    res = {dev: small_train_step(cfg, state, batch, replay.on(dev), dev, what)
           for dev in ("cpu", device)}
    cpu, gpu = res["cpu"][0], res[device][0]
    discrete = [k for k in cpu if k in ("num_pos_rois", "num_pos") or k.startswith("rcnn_acc")]
    worst = {}
    for k, r in cpu.items():
        if k in discrete:
            if gpu[k] != r:
                fail(f"{what}: {k} {gpu[k]} on the card, {r} on the CPU")
            continue
        worst[k] = abs(gpu[k] - r) / max(abs(r), 1e-12)
    log(f"{what} card vs CPU: " + ", ".join(
        f"{k} {cpu[k]:.6g} rel {worst[k]:.2e}" for k in sorted(worst))
        + "; " + ", ".join(f"{k} {cpu[k]:.4f}" for k in discrete) + " equal"
        " (bounds: losses 1e-4, grad norms 1e-3 relative)")
    for k, rel in worst.items():
        if rel > (1e-3 if "norm" in k else 1e-4):
            fail(f"{what}: {k} differs by {rel:.2e} relative between card and CPU")
    return cfg, state, batch, replay, res[device]


def train_stage_breakdown(trainer, batch, reps: int) -> dict:
    """Mean device-timeline ms of each stage of a training step (the calls
    of ``Trainer.run_step``, split at the module boundaries by CUDA events),
    and, with a mask head, the time of the mask term of the loss alone
    (inside the loss stage) -> (stages, {name: ms} outside the step)."""
    import torch

    from mxdetection_tpu_torch.models.detectors.rcnn import mask_loss, rcnn_loss

    model, marks = trainer.model, []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    hooks = [
        model.backbone.register_forward_hook(lambda *_: mark("backbone")),
        model.fpn.register_forward_hook(lambda *_: mark("fpn")),
        model.rpn.register_forward_hook(lambda *_: mark("rpn_head")),
    ]
    n = model.num_stages
    for i in range(n):  # a cascade stage: (decode + relabel of the last +) RoIAlign, its head
        before = ("proposals + sample_rois + roi_align" if i == 0
                  else f"decode{i - 1} + relabel{i} + roi_align{i}")
        after = "bbox_head" if n == 1 else f"bbox_head{i}"
        hooks += [
            model.bbox_head(i).register_forward_pre_hook(lambda *_, b=before: mark(b)),
            model.bbox_head(i).register_forward_hook(lambda *_, a=after: mark(a)),
        ]
    mask = model.mask_head is not None
    if mask:
        hooks += [
            model.mask_head.register_forward_pre_hook(
                lambda *_: mark("reg targets + mask roi_align")),
            model.mask_head.register_forward_hook(lambda *_: mark("mask_head")),
        ]
    totals, apart = {}, {}
    try:
        for _ in range(reps):
            marks.clear()
            mark("start")
            tb = trainer.device_batch(batch)
            mark("batch_transform")
            for p in trainer.params:
                p.grad = None
            out = model.forward_train(tb, trainer.draws)
            mark("mask targets" if mask else "targets")
            loss, _ = rcnn_loss(out, tb, trainer.draws, trainer.cfg)
            mark("rcnn_loss (anchor assign, mask loss)" if mask else "rcnn_loss (anchor assign)")
            loss.backward()
            mark("backward")
            trainer.optimizer.step([p.grad for p in trainer.params])
            mark("optimizer")
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(marks, marks[1:]):
                totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / reps
            if mask:
                with torch.no_grad():
                    ms = time_ms(lambda: mask_loss(out, trainer.cfg), reps=1)
                apart["mask loss (in rcnn_loss)"] = apart.get("mask loss (in rcnn_loss)",
                                                              0.0) + ms / reps
    finally:
        for h in hooks:
            h.remove()
    return totals, apart


def drive_train(trainer, batch, counters, card: str, what: str, profile_dir: str | None,
                trace_name: str) -> tuple:
    """``TRAIN_WARMUP`` warm-up steps and ``TRAIN_STEPS`` timed ones, every
    launch count set to 0 just before the timed steps and read just after;
    fails if a counted kernel was never launched or the step is not finite.
    Returns the launches, the median ms per step and the peak GiB."""
    import os

    import torch

    log(f"{what}: {int(batch['gt_valid'].sum())} gt boxes in the batch of {MAIN_BATCH}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        t0 = time.perf_counter()
        m = trainer.run_step(batch)
        torch.cuda.synchronize()
        log(f"{what} warm-up step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
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
            fail(f"{what} never launched the {name} kernel")
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        fail(f"{what}: loss {float(m['loss'])}, grad norm {float(m['grad_norm'])}")
    q = torch.tensor(times).quantile(torch.tensor([0.25, 0.5, 0.75])).tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{what} ms per step ({card}): " + ", ".join(f"{ms:.2f}" for ms in times))
    log(f"{what}: {TRAIN_STEPS} steps of {MAIN_BATCH}x832x1344 bf16, ms per step: "
        f"p25 {q[0]:.2f}, median {q[1]:.2f}, p75 {q[2]:.2f}, max {max(times):.2f}; "
        f"median {MAIN_BATCH * 1e3 / q[1]:.1f} images/s; peak memory {peak:.2f} GiB ({card})")
    log(f"{what}: losses {', '.join(f'{x:.4f}' for x in losses)}; last step "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(m.items()))
        + f"; launches per step {({k: n / TRAIN_STEPS for k, n in launches.items()})}")
    if profile_dir is not None:
        stages, apart = train_stage_breakdown(trainer, batch, reps=3)
        total = sum(stages.values())
        for name, ms in stages.items():
            log(f"profile {what} stage {name}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
        for name, ms in apart.items():
            log(f"profile {what}: {name} alone {ms:.3f} ms")
        trace(lambda: trainer.run_step(batch), 2, f"{what} step",
              os.path.join(profile_dir, trace_name))
    return launches, q[1], peak


def phase_train_path(device, card: str, counters, profile_dir: str | None,
                     capture: CaptureRoi, nms_capture: CaptureNms) -> tuple:
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
    with capture, nms_capture:
        return drive_train(trainer, batch, counters, card, "train path", profile_dir,
                           "train_step_trace.json.gz")


# --------------------------------------------------------------------------
# phase 10: K6 + K6b, K7 + K7b


def dcn_bwd_bounds(off, h: int, w: int, c: int, stride: int, dtype) -> tuple:
    """(K6's, K7's) (least ms, bound by) on these offsets, Cin = Cout = c.
    K6 reads x, the offsets, dpatch and g once and writes dW (f32) and
    doffsets once, does about 21 f32 operations per sampled value (the
    blend's 7, two derivative terms of 7) and the product's 2 * M * 9c * c
    on the tensor cores (bf16) or the f32 units; K7 reads dpatch and the
    offsets and writes an f32 dx once, and does a multiply and an add for
    each channel of each corner inside the map with a nonzero weight,
    counted on these offsets."""
    import torch

    from mxdetection_tpu_torch.ops.dcn import _bilinear_weights, _corners

    b, ho, wo = off.shape[:3]
    m = b * ho * wo
    size = 2 if dtype == torch.bfloat16 else 4
    ly, lx, corners = _corners((b, h, w), off, kernel=3, stride=stride, dilation=1, radius=None)
    live = sum(int(((wgt * inb) != 0).sum()) for (_, inb), wgt in
               zip(corners, _bilinear_weights(ly, lx)))
    k6_bytes = (b * h * w * c * size + m * 18 * 4 + m * 9 * c * size + m * c * size
                + 9 * c * c * 4 + m * 18 * 4)
    gemm = 2.0 * m * 9 * c * c
    k6 = (bound(k6_bytes, 21.0 * m * 9 * c, gemm) if dtype == torch.bfloat16
          else bound(k6_bytes, 21.0 * m * 9 * c + gemm))
    k7 = bound(m * 9 * c * size + m * 18 * 4 + b * h * w * c * 4, 2.0 * live * c)
    return k6, k7


def rel_norm(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp(min=1e-30))


def col2im_checks(device, gen) -> dict:
    """K7's windows against offsets they do not hold, f32 and bf16 dpatch
    each within 1e-4 of the largest value of the plain ``deform_col2im`` on
    the same dpatch: at a stage-3 and a stage-2 stride-2 shape, offsets of
    std 6 cells with one value in a thousand set to +-40, so corners land far
    outside every window and outside the map (the spills, counted by the
    plain model, must be nonzero); and at dilation 2 with offsets of std 1.5
    cells. Times K7 on the bf16 dpatch of each, beside the share of corners
    that spill; -> {check: (ms, spill share)}."""
    import torch

    from mxdetection_tpu_torch.ops import dcn as tdcn
    from mxdetection_tpu_torch.ops.cuda.deform_conv import (col2im_window_split,
                                                            deform_col2im_cuda)

    b = MAIN_BATCH
    times = {}
    for what, (h, w, c), stride, dilation, std in (
            ("spill-heavy stage3 s1", (52, 84, 256), 1, 1, 6.0),
            ("spill-heavy stage2 s2", (208, 336, 128), 2, 1, 6.0),
            ("dilation 2 stage3 s1", (52, 84, 256), 1, 2, 1.5)):
        ho, wo = -(-h // stride), -(-w // stride)
        off = torch.randn((b, ho, wo, 18), generator=gen) * std
        if std > 3:
            far = torch.rand(off.shape, generator=gen) < 1e-3
            off[far] = 40.0 * torch.sign(torch.randn(int(far.sum()), generator=gen))
        off = off.to(device)
        dp32 = torch.randn((b, ho, wo, 9 * c), generator=gen).to(device)
        kw = dict(stride=stride, dilation=dilation)
        n_spilled = col2im_window_split(dp32, off, (b, h, w, c), **kw)[2]
        share = n_spilled / (b * ho * wo * 36)
        for dt, dp in (("f32", dp32), ("bf16", dp32.bfloat16())):
            got = deform_col2im_cuda(dp, off, (b, h, w, c), **kw)
            ref = tdcn.deform_col2im(dp, off, (b, h, w, c), **kw)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= 1e-4 * scale
            log(f"K7 {what} {h}x{w}x{c}, dilation {dilation}, offsets std {std} ({dt} dpatch): "
                f"max_abs_err {err:.3e} of max|ref| {scale:.3e} (<= 1e-4 max|ref|: "
                f"{'ok' if ok else 'FAILED'}); {n_spilled} of {b * ho * wo * 36} corners spilled "
                f"({100 * share:.2f} %)")
            if not ok:
                fail(f"K7 {what} ({dt} dpatch): disagrees with deform_col2im")
            del got, ref
        if std > 3 and n_spilled == 0:
            fail(f"K7 {what}: no corner spilled out of the windows")
        times[what] = (time_ms(lambda: deform_col2im_cuda(dp, off, (b, h, w, c), **kw)), share)
        log(f"K7 {what}: bf16 {times[what][0]:.4f} ms a call with {100 * share:.2f} % of the "
            "corners spilled")
        del off, dp32, dp
        torch.cuda.empty_cache()
    return times


def phase_deform_conv_bwd(device) -> dict:
    """K6/K6b and K7/K7b against their plain versions at the six DCN layer
    shapes of the cascade path, batch 8, offsets of std 1.5 cells: f32 dW,
    doffsets and dx within 1e-4 of the largest value, and the bf16 builds on
    the main path's bf16 inputs too; the whole bf16 backward
    (``DeformConvFunction``) against the f32 plain one, norm-relative under
    3 % for dx and dW and 6 % for doffsets. Times each kernel, its plain
    version and cuDNN's conv backward of the same shape (dgrad beside K7,
    wgrad beside K6: the same function only at zero offsets), the dW matmul
    on the plain version's patches that K6 replaced, and K7 again on
    offsets of std 1 cell (about the main path's), beside the share of
    corners that spill out of K7's windows at both; logs the peak memory of
    the whole DCN backward at the stage-3 shape. Then K7's spill-heavy and
    dilation-2 checks (``col2im_checks``) and the radius-3, ragged-M and
    zero-offset checks."""
    import torch
    import torch.nn.functional as F

    from mxdetection_tpu_torch.ops import dcn as tdcn
    from mxdetection_tpu_torch.ops.cuda.deform_conv import (col2im_window_split,
                                                            deform_col2im_cuda,
                                                            deform_wgrad_doffsets_cuda)

    k6_build_facts(device)
    k7_build_facts()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(20)
    b = MAIN_BATCH
    conv_bwd = torch.ops.aten.convolution_backward
    empty = lambda: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,  # noqa: E731
                     "library_ms": 0.0, "bound_ms_by": {"bytes": 0.0, "operations": 0.0},
                     "by_shape": {}}
    res = {(kind, stride): empty() for kind in ("k6", "k7") for stride in (1, 2)}
    for stage, h, w, c, stride, n in DCN_LAYERS:
        ho, wo = -(-h // stride), -(-w // stride)
        shape = f"{stage} s{stride} {h}x{w}x{c}"
        x32 = torch.randn((b, h, w, c), generator=gen).to(device)
        off = (torch.randn((b, ho, wo, 18), generator=gen) * 1.5).to(device)
        w32 = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).to(device)
        g32 = torch.randn((b, ho, wo, c), generator=gen).to(device)
        kw = dict(stride=stride)

        # f32: each kernel against its plain version on the same dpatch
        g2_32 = g32.reshape(-1, c)
        dp32 = (g2_32 @ w32.reshape(9 * c, c).t()).reshape(b, ho, wo, 9 * c)
        dw_ref, d_ref = tdcn.deform_wgrad_doffsets(x32, off, dp32, g2_32, **kw)
        dw_got, d_got = deform_wgrad_doffsets_cuda(x32, off, dp32, g2_32, **kw)
        dx_ref = tdcn.deform_col2im(dp32, off, x32.shape, **kw)
        dx_got = deform_col2im_cuda(dp32, off, x32.shape, **kw)
        torch.cuda.synchronize()
        errs = {}

        def hold(name, got, ref):
            errs[name] = ((got - ref).abs().max().item(), ref.abs().max().item())
            if not torch.isfinite(got).all() or errs[name][0] > 1e-4 * errs[name][1]:
                fail(f"K6/K7 {shape} {name}: max_abs_err {errs[name][0]:.3e} of max|ref| "
                     f"{errs[name][1]:.3e} (bound 1e-4 max|ref|)")

        for name, got, ref in (("dW", dw_got, dw_ref), ("doffsets", d_got, d_ref),
                               ("dx", dx_got, dx_ref)):
            hold(name, got, ref)
        del dw_got, d_got

        # bf16: the Function's backward on the card against the f32 plain one
        x16, w16, g16 = (t.bfloat16().requires_grad_() for t in (x32, w32, g32))
        off16 = off.clone().requires_grad_()
        tdcn.deform_conv2d_batched(x16, off16, w16, **kw).backward(g16)
        torch.cuda.synchronize()
        rel = {"dx": rel_norm(x16.grad, dx_ref), "doffsets": rel_norm(off16.grad, d_ref),
               "dW": rel_norm(w16.grad, dw_ref.reshape(3, 3, c, c))}
        ok16 = rel["dx"] < 0.03 and rel["dW"] < 0.03 and rel["doffsets"] < 0.06
        del dx_ref, d_ref, dw_ref, dx_got

        x16, w16, g16 = x16.detach(), w16.detach(), g16.detach()
        g2 = g16.reshape(-1, c)
        dp16 = (g2 @ w16.reshape(9 * c, c).t()).reshape(b, ho, wo, 9 * c)
        k6 = lambda: deform_wgrad_doffsets_cuda(x16, off, dp16, g2, **kw)  # noqa: E731
        k6_plain = lambda: tdcn.deform_wgrad_doffsets(x16, off, dp16, g2, **kw)  # noqa: E731
        k7 = lambda: deform_col2im_cuda(dp16, off, x16.shape, **kw)  # noqa: E731
        k7_plain = lambda: tdcn.deform_col2im(dp16, off, x16.shape, **kw)  # noqa: E731
        # the bf16 builds against the plain versions on the same bf16 inputs
        (dw16, d16), (dw16_ref, d16_ref) = k6(), k6_plain()
        dx16, dx16_ref = k7(), k7_plain()
        torch.cuda.synchronize()
        for name, got, ref in (("dW bf16", dw16, dw16_ref), ("doffsets bf16", d16, d16_ref),
                               ("dx bf16", dx16, dx16_ref)):
            hold(name, got, ref)
        del dw16, d16, dw16_ref, d16_ref, dx16, dx16_ref
        off1 = off / 1.5  # the same draws at std 1 cell
        k7_std1 = lambda: deform_col2im_cuda(dp16, off1, x16.shape, **kw)  # noqa: E731
        spill = {std: col2im_window_split(dp16[:1], o[:1], (1, h, w, c), **kw)[2]
                 / (ho * wo * 9 * 4) for std, o in ((1.5, off), (1.0, off1))}
        xc = x16.permute(0, 3, 1, 2)  # NCHW views of NHWC memory: channels_last
        gc = g16.permute(0, 3, 1, 2)
        wc = w16.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cudnn = lambda mask: lambda: conv_bwd(gc, xc, wc, None, [stride] * 2, [1, 1],  # noqa: E731
                                              [1, 1], False, [0, 0], 1, mask)
        leaves = [t.clone().requires_grad_() for t in (x16, off, w16)]
        out = tdcn.deform_conv2d_batched(*leaves, **kw)
        whole = lambda: torch.autograd.grad(out, leaves, g16, retain_graph=True)  # noqa: E731
        w2 = w16.reshape(9 * c, c)
        p2 = tdcn.deform_patches_doffsets(x16, off, dp16, **kw)[0].reshape(-1, 9 * c)
        plain6, plain7 = time_ms(k6_plain, reps=3, warmup=1), time_ms(k7_plain, reps=3, warmup=1)
        t = {"k6": time_ms(k6), "k7": time_ms(k7), "k7_std1": time_ms(k7_std1),
             "wgrad": time_ms(cudnn([False, True, False])),
             "dgrad": time_ms(cudnn([True, False, False])),
             "whole": time_ms(whole), "cudnn": time_ms(cudnn([True, True, False])),
             "dpatch_mm": time_ms(lambda: torch.matmul(g2, w2.t())),
             "dw_mm": time_ms(lambda: tdcn._matmul_f32(p2.t(), g2))}
        plain6 = (plain6 + time_ms(k6_plain, reps=3, warmup=1)) / 2
        plain7 = (plain7 + time_ms(k7_plain, reps=3, warmup=1)) / 2
        peak = None
        if stage == "stage3" and stride == 1:  # the whole backward's peak above what it holds
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = whole()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del grads
            log(f"whole DCN backward {shape}, bf16: peak device memory {peak / 2 ** 20:.1f} MiB "
                f"above its inputs (torch.cuda.max_memory_allocated); the (M, 9C) bf16 patches "
                f"it no longer makes would be {b * ho * wo * 9 * c * 2 / 2 ** 20:.1f} MiB")
        del p2
        (b6, by6), (b7, by7) = dcn_bwd_bounds(off, h, w, c, stride, torch.bfloat16)
        tag = "b" if stride == 2 else ""
        log(f"K6{tag}/K7{tag} {shape} -> {ho}x{wo}, x{n} a batch: f32 max_abs_err dW "
            f"{errs['dW'][0]:.3e} of {errs['dW'][1]:.3e}, doffsets {errs['doffsets'][0]:.3e} of "
            f"{errs['doffsets'][1]:.3e}, dx {errs['dx'][0]:.3e} of {errs['dx'][1]:.3e}; bf16 "
            f"inputs: dW {errs['dW bf16'][0]:.3e} of {errs['dW bf16'][1]:.3e}, doffsets "
            f"{errs['doffsets bf16'][0]:.3e} of {errs['doffsets bf16'][1]:.3e}, dx "
            f"{errs['dx bf16'][0]:.3e} of {errs['dx bf16'][1]:.3e} (<= 1e-4 max|ref|: ok); bf16 "
            f"backward vs f32 plain, norm-relative: dx {rel['dx']:.4f}, dW {rel['dW']:.4f} "
            f"(< 0.03), doffsets {rel['doffsets']:.4f} (< 0.06): {'ok' if ok16 else 'FAILED'}")
        log(f"K6{tag} bf16 {t['k6']:.4f} ms (replaces the patches kernel and the dW matmul, "
            f"alone {t['dw_mm']:.4f} ms here), plain {plain6:.4f} ms, cuDNN wgrad "
            f"{t['wgrad']:.4f} ms, bound {b6:.4f} ms ({by6}); K7{tag} bf16 {t['k7']:.4f} ms, "
            f"plain {plain7:.4f} ms, cuDNN dgrad {t['dgrad']:.4f} ms, bound {b7:.4f} ms "
            f"({by7}), {t['k7_std1']:.4f} ms on offsets of std 1 (corners spilled out of the "
            f"windows, image 0: {100 * spill[1.5]:.3f} % at std 1.5, {100 * spill[1.0]:.3f} % "
            f"at std 1); whole DCN backward {t['whole']:.4f} ms (matmul dpatch = g W^T "
            f"{t['dpatch_mm']:.4f} ms), cuDNN conv backward {t['cudnn']:.4f} ms ({shape})")
        if not ok16:
            fail(f"the bf16 DCN backward disagrees with the f32 plain one at {shape}")
        for kind, ms, plain_ms, lib_ms, bnd, by, err in (
                ("k6", t["k6"], plain6, t["wgrad"], b6, by6,
                 max(errs[k][0] for k in ("dW", "doffsets", "dW bf16", "doffsets bf16"))),
                ("k7", t["k7"], plain7, t["dgrad"], b7, by7,
                 max(errs["dx"][0], errs["dx bf16"][0]))):
            r = res[(kind, stride)]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bnd),
                         ("library_ms", lib_ms)):
                r[k] += n * v  # per step of the cascade path
            r["bound_ms_by"][by] += n * bnd
            r["bound_by"] = max(r["bound_ms_by"], key=r["bound_ms_by"].get)
            r["by_shape"][shape] = {"layers": n, "ms": ms, "plain_ms": plain_ms,
                                    "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
                                    "whole_bwd_ms": t["whole"], "cudnn_bwd_ms": t["cudnn"],
                                    **({"ms_std1": t["k7_std1"], "spill_share": spill[1.5],
                                        "spill_share_std1": spill[1.0]} if kind == "k7" else
                                       {"dw_mm_ms": t["dw_mm"]}),
                                    **({"whole_bwd_peak_bytes": peak} if peak else {}),
                                    "dpatch_mm_ms": t["dpatch_mm"]}
        del x32, off, off1, w32, g32, dp32, x16, w16, g16, dp16, leaves, out, off16, g2, w2
        torch.cuda.empty_cache()
    for what, (ms, share) in col2im_checks(device, torch.Generator().manual_seed(21)).items():
        res[("k7", 2 if "s2" in what else 1)].setdefault("spill_checks", {})[what] = {
            "ms": ms, "spill_share": share}

    # radius 3 and zero offsets, in f32, at a stage-3 shape
    x = torch.randn((b, 52, 84, 256), generator=gen).to(device)
    off = (torch.randn((b, 52, 84, 18), generator=gen) * 1.5).to(device)
    wt = (torch.randn((3, 3, 256, 256), generator=gen) * (2.0 / (9 * 256)) ** 0.5).to(device)
    g = torch.randn((b, 52, 84, 256), generator=gen).to(device)
    g2 = g.reshape(-1, 256)
    dp = (g2 @ wt.reshape(-1, 256).t()).reshape(b, 52, 84, -1)
    got6 = deform_wgrad_doffsets_cuda(x, off, dp, g2, radius=3)
    ref6 = tdcn.deform_wgrad_doffsets(x, off, dp, g2, radius=3)
    checks = [("radius 3 dW", got6[0], ref6[0]), ("radius 3 doffsets", got6[1], ref6[1]),
              ("radius 3 dx", deform_col2im_cuda(dp, off, x.shape, radius=3),
               tdcn.deform_col2im(dp, off, x.shape, radius=3))]
    if got6[1][off.abs() > 3].abs().max().item() != 0.0:
        fail("K6 radius 3: a nonzero offset gradient beyond the clamp")
    leaves = [t.clone().requires_grad_() for t in (x, torch.zeros_like(off), wt)]
    tdcn.deform_conv2d_batched(*leaves).backward(g)
    xc, wc = x.permute(0, 3, 1, 2).requires_grad_(), wt.permute(3, 2, 0, 1).requires_grad_()
    F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1).backward(g)
    checks += [("zero offsets dx vs F.conv2d", leaves[0].grad, xc.grad.permute(0, 2, 3, 1)),
               ("zero offsets dW vs F.conv2d", leaves[2].grad, wc.grad.permute(2, 3, 1, 0))]
    # K6 in bf16 at zero offsets against cuDNN's wgrad of the same bf16 values
    # (computed in f32, TF32 off): the same exact products, summed in another order
    for h, w, c in ((52, 84, 256), (26, 42, 512)):
        x16 = torch.randn((b, h, w, c), generator=gen).to(device).bfloat16()
        g16 = torch.randn((b, h, w, c), generator=gen).to(device).bfloat16()
        w16 = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).to(device)
        w16 = w16.bfloat16()
        dp16 = (g16.reshape(-1, c) @ w16.reshape(9 * c, c).t()).reshape(b, h, w, 9 * c)
        dw16 = deform_wgrad_doffsets_cuda(x16, torch.zeros((b, h, w, 18), device=device), dp16,
                                          g16.reshape(-1, c))[0]
        wgrad = conv_bwd(g16.float().permute(0, 3, 1, 2), x16.float().permute(0, 3, 1, 2),
                         w16.float().permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False,
                         [0, 0], 1, [False, True, False])[1]
        checks.append((f"zero offsets bf16 dW vs cuDNN wgrad {h}x{w}x{c}", dw16,
                       wgrad.permute(2, 3, 1, 0).reshape(9 * c, c)))
    # a ragged M (2 x 19 x 23 and 2 x 10 x 12 pixels: no whole 64-pixel chunk
    # at the end) at both strides, f32 and bf16
    xs = torch.randn((2, 19, 23, 128), generator=gen).to(device)
    for stride in (1, 2):
        ho, wo = -(-19 // stride), -(-23 // stride)
        offs = (torch.randn((2, ho, wo, 18), generator=gen) * 1.5).to(device)
        dps = torch.randn((2, ho, wo, 9 * 128), generator=gen).to(device)
        gs = torch.randn((2 * ho * wo, 256), generator=gen).to(device)
        for dt in (torch.float32, torch.bfloat16):
            args = (xs.to(dt), offs, dps.to(dt), gs.to(dt))
            got, ref = (deform_wgrad_doffsets_cuda(*args, stride=stride),
                        tdcn.deform_wgrad_doffsets(*args, stride=stride))
            name = f"ragged M 2x19x23x128 -> 256 stride {stride} {str(dt)[6:]}"
            checks += [(f"{name} dW", got[0], ref[0]), (f"{name} doffsets", got[1], ref[1])]
    torch.cuda.synchronize()
    for what, got, ref in checks:
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        log(f"K6/K7 {what}: max_abs_err {err:.3e} of max|ref| {scale:.3e} "
            f"(<= 1e-4 max|ref|: {'ok' if err <= 1e-4 * scale else 'FAILED'})")
        if not err <= 1e-4 * scale:
            fail(f"K6/K7 {what}: disagrees with its reference")
    return res


# --------------------------------------------------------------------------
# phase 11: the Cascade R-CNN R101-DCN training path


def first_dcn_of_each_stage(state: dict) -> dict:
    """``state`` with every offset conv zeroed but those of the first block
    of stages 2-4 (noise in all 30 DCN layers makes a random-weight net
    chaotic, so that a card-vs-CPU check would measure summation order)."""
    import torch

    keep = tuple(f"backbone.layer{s}_block0." for s in (2, 3, 4))
    return {k: (v if ".offset_conv." not in k or k.startswith(keep) else torch.zeros_like(v))
            for k, v in state.items()}


def phase_cascade_train_path(device, card: str, counters, profile_dir: str | None) -> dict:
    """Cascade R-CNN R101-DCN training: seed 0 weights whose offset convs
    are calibrated on a full-size batch as the inference path's (offsets of
    std about 1 cell), a card-vs-CPU f32 step at 256x320 with that noise in
    the first DCN of each stage, then ``Trainer.run_step`` at 8x832x1344 in
    bf16."""
    import copy

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector
    from mxdetection_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(CASCADE, {"data.batch_size_per_device": MAIN_BATCH})
    small = cfg.override(**SMALL_TRAIN_OVERRIDES)
    t0 = time.perf_counter()
    model = build_detector(small, device="cpu", seed=0, train=True)  # f32 everywhere
    log(f"cascade train path: {cfg.name}, seeded init in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(12)
    raw = torch.randint(0, 256, (MAIN_BATCH, 480, 640, 3), generator=gen,
                        dtype=torch.uint8).to(device)
    hw = torch.tensor([[480.0, 640.0]] * MAIN_BATCH, device=device)
    gpu_model = copy.deepcopy(model).to(device)
    seed_offset_convs(gpu_model, cfg, raw, hw, torch.Generator().manual_seed(11))
    state = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    del model, gpu_model

    small_train_parity(device, CASCADE, first_dcn_of_each_stage(state),
                       "cascade small f32 train step")

    model = build_detector(cfg, device="cpu", train=True)
    model.load_state_dict(state)
    trainer = Trainer(cfg, model, device=device, steps_per_epoch=117266 // MAIN_BATCH)
    log(f"cascade train path: f32 master weights, {cfg.backbone.dtype} compute, "
        f"{len(dcn_layers(trainer.model))} DCN layers, offset convs seeded as above")
    batch = train_batch(MAIN_BATCH, (480, 640), torch.Generator().manual_seed(9), device)
    launches, _, _ = drive_train(trainer, batch, counters, card, "cascade train path",
                                 profile_dir, "cascade_train_trace.json.gz")
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    want = {"deform_conv": 27, "deform_conv_s2": 3, "deform_wgrad_doffsets": 27,
            "deform_wgrad_doffsets_s2": 3, "deform_col2im": 27, "deform_col2im_s2": 3}
    if any(per_step.get(k) != v for k, v in want.items()):
        fail(f"cascade train path: expected {want} launches a step, got {per_step}")
    return launches


# --------------------------------------------------------------------------
# phase 12: the SyncBN data-parallel training path


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_remat(device, cfg, state, batch, replay, plain: tuple) -> None:
    """The small card step of ``small_train_parity`` again with
    ``backbone.remat``: the same losses and grad norms within 1e-5
    relative, and the same running statistics (within 1e-6 of their
    largest value): the recompute must not move them a second time."""
    res, stats = small_train_step(cfg.override(**{"backbone.remat": True}), state, batch,
                                  replay.on(device), device, "small f32 SyncBN step, remat")
    ref, ref_stats = plain
    if set(res) != set(ref) or set(stats) != set(ref_stats):
        fail("small SyncBN step with remat: other metrics or statistics than without")
    worst = max(abs(res[k] - r) / max(abs(r), 1e-12) for k, r in ref.items())
    stat_gap = max(float((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                   for k, v in ref_stats.items())
    log(f"small SyncBN step with remat against without, on the card: metrics and grad norms "
        f"within {worst:.2e} relative, running statistics within {stat_gap:.2e} of their "
        f"largest value (bounds 1e-5, 1e-6)")
    if worst > 1e-5 or stat_gap > 1e-6:
        fail("small SyncBN step: remat changed the step")


def check_checkpoint(cfg, trainer, batch, device, steps_per_epoch: int) -> None:
    """Save after step 1, run step 2; restore into a fresh ``Trainer``
    (other weights) and run step 2 again: the metrics within 1e-6 relative
    (cuDNN's backward need not be deterministic)."""
    import os
    import tempfile

    from mxdetection_tpu_torch.train.checkpoint import CheckpointManager
    from mxdetection_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)
        trainer.run_step(batch)
        t0 = time.perf_counter()
        ckpt.save(trainer)
        save_s = time.perf_counter() - t0
        ref = {k: float(v) for k, v in trainer.run_step(batch).items()}
        fresh = Trainer(cfg, device=device, seed=1, steps_per_epoch=steps_per_epoch)
        t0 = time.perf_counter()
        step = ckpt.restore(fresh)
        restore_s = time.perf_counter() - t0
        got = {k: float(v) for k, v in fresh.run_step(batch).items()}
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    worst = max(abs(got[k] - r) / max(abs(r), 1e-12) for k, r in ref.items())
    log(f"sync_bn train path: checkpoint of step {step} ({size / 2**20:.1f} MiB, saved in "
        f"{save_s:.2f} s, restored in {restore_s:.2f} s); step 2 resumed in a fresh Trainer "
        f"against the original: within {worst:.2e} relative (bound 1e-6)")
    if step != 1 or set(got) != set(ref) or worst > 1e-6:
        fail(f"sync_bn train path: the resumed step differs by {worst:.2e} relative")


def phase_sync_bn_train_path(device, card: str, counters, profile_dir: str | None,
                             faster: tuple) -> dict:
    """``multihost_dp_faster_rcnn_v5p16``: SyncBN in every backbone norm,
    every stage training, the data-parallel ``Trainer`` in a NCCL process
    group of world size 1. A card-vs-CPU f32 step at 256x320 and the same
    step with remat; then at 8x832x1344 in bf16 a checkpoint round trip,
    ``TRAIN_WARMUP`` + ``TRAIN_STEPS`` steps beside the Faster step's
    ``faster`` (median ms, peak GiB), and the peak memory with remat."""
    import torch
    import torch.distributed as dist

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.layers import SyncBatchNorm
    from mxdetection_tpu_torch.parallel.mesh import initialize_multihost
    from mxdetection_tpu_torch.train.trainer import Trainer

    check_remat(device, *small_train_parity(device, SYNC, what="small f32 SyncBN train step"))

    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        one = torch.ones(1, device=device)
        dist.all_reduce(one)
        if float(one) != 1.0:
            fail(f"NCCL all_reduce at world size 1 gave {float(one)}")
        log(f"sync_bn train path: {dist.get_backend()} process group of "
            f"{dist.get_world_size()}")
        cfg = load_config(SYNC, {"data.batch_size_per_device": MAIN_BATCH})
        steps_per_epoch = 117266 // MAIN_BATCH
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=device, seed=0, steps_per_epoch=steps_per_epoch)
        norms = [m for m in trainer.model.modules() if isinstance(m, SyncBatchNorm)]
        log(f"sync_bn train path: {cfg.name}, {len(norms)} SyncBN layers, frozen_stages "
            f"{cfg.backbone.frozen_stages}, {trainer.replicas} replica, f32 master weights, "
            f"{cfg.backbone.dtype} compute, seeded init in {time.perf_counter() - t0:.1f} s")
        batch = train_batch(MAIN_BATCH, (480, 640), torch.Generator().manual_seed(9), device)
        check_checkpoint(cfg, trainer, batch, device, steps_per_epoch)
        launches, median, peak = drive_train(trainer, batch, counters, card, "sync_bn train path",
                                             profile_dir, "sync_bn_train_trace.json.gz")
        stats = torch.cat([torch.cat([m.mean, m.var]) for m in norms])
        moved = sum(bool((m.mean != 0).any() and (m.var != 1).any()) for m in norms)
        if not torch.isfinite(stats).all() or moved != len(norms):
            fail(f"sync_bn train path: running statistics finite "
                 f"{bool(torch.isfinite(stats).all())}, moved in {moved} of {len(norms)} layers")
        log(f"sync_bn train path: running statistics finite and moved in all {len(norms)} "
            f"layers; median {median:.2f} ms a step against the Faster step's {faster[0]:.2f} "
            f"ms, peak {peak:.2f} GiB against {faster[1]:.2f} GiB, in this run ({card})")
        del trainer
        torch.cuda.empty_cache()
        remat = Trainer(cfg.override(**{"backbone.remat": True}), device=device, seed=0,
                        steps_per_epoch=steps_per_epoch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            m = remat.run_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(m["loss"]):
            fail(f"sync_bn train path with remat: loss {float(m['loss'])}")
        log(f"sync_bn train path with backbone.remat: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB against {peak:.2f} GiB "
            f"without; steps 1-3 ms {', '.join(f'{t:.2f}' for t in times)} ({card})")
        del remat
    finally:
        dist.destroy_process_group()
    return launches


# --------------------------------------------------------------------------
# phase 13: the Mask R-CNN path


def phase_mask_path(device, card: str, counters: list, train_counters: list,
                    profile_dir: str | None) -> tuple:
    """Mask R-CNN R50-FPN (``mask_rcnn_r50_fpn_1x``). K1 and K3 at P = 14,
    the mask branch's RoIAlign, against their plain versions on 8 x 128
    synthetic rois, and K3 against its plain model there; the card against
    the CPU at 256x320 in f32 (detections and mask probabilities, and one
    training step); then at 8x832x1344 in bf16 ``TIMED_BATCHES`` batches of
    ``forward_test`` + ``rcnn_postprocess`` + ``mask_probs`` (``counters``)
    and ``TRAIN_WARMUP`` + ``TRAIN_STEPS`` steps of ``Trainer.run_step``
    with box masks (``train_counters``); K1 on the first batch's
    detections, and K1 and K3 on the first step's mask rois. Returns
    ({path: launches}, K1's P = 14 record, K3's)."""
    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector
    from mxdetection_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = k1_synthetic(device, MASK_P, MASK_ROIS, torch.Generator().manual_seed(21))
    k3_model_check(device, MASK_P, ((256, 2),))
    k3 = k3_synthetic(device, MASK_P, MASK_ROIS, torch.Generator().manual_seed(22))
    small_parity(device, MASK, "mask small f32 input")
    small_train_parity(device, MASK, what="mask small f32 train step")

    cfg = load_config(MASK)
    dtype = getattr(torch, cfg.backbone.dtype)
    t0 = time.perf_counter()
    model = build_detector(cfg, device=device, seed=0)
    log(f"mask path: {cfg.name}, {cfg.backbone.dtype}, mask head {cfg.mask_head}, seeded init "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(4)  # the Faster R-CNN path's canvases
    raw = torch.randint(0, 256, (MAIN_BATCH, 480, 640, 3), generator=gen,
                        dtype=torch.uint8).to(device)
    hw = torch.tensor([[480.0, 640.0]] * MAIN_BATCH, device=device)
    dets_capture = CaptureRoi(backward=False, p=MASK_P)
    with dets_capture:
        launches = {"mask_inference": drive(model, cfg, raw, hw, dtype, counters, card,
                                            "mask path")[0]}
    per_batch = {k: n / (TIMED_BATCHES + 1) for k, n in launches["mask_inference"].items()}
    log(f"mask path: launches per batch {per_batch}")
    if per_batch.get("roi_align") != 2:
        fail(f"mask path: expected 2 K1 launches a batch (7x7 and 14x14), got {per_batch}")
    if profile_dir is not None:
        phase_profile(model, cfg, raw, hw, dtype, profile_dir, label="mask_path")
    del model

    cfg = load_config(MASK, {"data.batch_size_per_device": MAIN_BATCH})
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device, seed=0, steps_per_epoch=117266 // MAIN_BATCH)
    log(f"mask train path: f32 master weights, {cfg.backbone.dtype} compute, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(MAIN_BATCH, (480, 640), torch.Generator().manual_seed(9), device)
    step_capture = CaptureRoi(p=MASK_P)
    with step_capture:
        launches["mask_train"] = drive_train(trainer, batch, train_counters, card,
                                             "mask train path", profile_dir,
                                             "mask_train_trace.json.gz")[0]
    per_step = {k: n / TRAIN_STEPS for k, n in launches["mask_train"].items()}
    if per_step.get("roi_align") != 2 or per_step.get("roi_align_bwd") != 2:
        fail(f"mask train path: expected 2 K1 and 2 K3 launches a step, got {per_step}")
    del trainer

    both = (torch.float32, torch.bfloat16)
    k1["mask_detections"] = k1_on_rois(device, dets_capture.first,
                                       "the first mask batch's detections", both, seed=23)
    cap = step_capture.first
    k3["mask_train_step"] = k3_on_rois(device, cap, "one mask training step's mask rois",
                                       seed=24)
    k1["mask_train_step"] = k1_on_rois(device, cap, "one mask training step's mask rois",
                                       both, seed=25)
    return launches, k1, k3


# --------------------------------------------------------------------------
# phases 14 and 15: RetinaNet, R-FCN


def phase_zoo_path(device, card: str, name: str, label: str, counters: list,
                   train_counters: list, per_batch: dict, per_step: dict,
                   train_overrides: dict | None = None, nms_capture=None) -> dict:
    """One more detector of the zoo, ``name``, with ``seeded_model``'s
    weights: the card against the CPU at 256x320 in f32 (detections, and
    one training step with ``train_overrides``), then at 8x832x1344 in bf16
    ``TIMED_BATCHES`` batches of ``forward_test`` + the registry's
    postprocess on the Faster path's canvases (``counters``, inside
    ``nms_capture`` if given) and ``TRAIN_WARMUP`` + ``TRAIN_STEPS`` steps of
    ``Trainer.run_step`` on the Faster step's batch (``train_counters``).
    Fails unless the launches a batch and a step are ``per_batch`` and
    ``per_step``. Returns {path: launches}."""
    import contextlib

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small_parity(device, name, f"{label} small f32 input")
    small_train_parity(device, name, what=f"{label} small f32 train step",
                       overrides=train_overrides)

    cfg = load_config(name)
    dtype = getattr(torch, cfg.backbone.dtype)
    t0 = time.perf_counter()
    model = seeded_model(cfg, device)
    log(f"{label} path: {cfg.name}, {cfg.backbone.dtype}, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(4)  # the Faster R-CNN path's canvases
    raw = torch.randint(0, 256, (MAIN_BATCH, 480, 640, 3), generator=gen,
                        dtype=torch.uint8).to(device)
    hw = torch.tensor([[480.0, 640.0]] * MAIN_BATCH, device=device)
    with nms_capture or contextlib.nullcontext():
        launches = {f"{label}_inference": drive(model, cfg, raw, hw, dtype, counters, card,
                                                f"{label} path")[0]}
    got = {k: n / (TIMED_BATCHES + 1) for k, n in launches[f"{label}_inference"].items()}
    log(f"{label} path: launches per batch {got}")
    if got != per_batch:
        fail(f"{label} path: expected launches per batch {per_batch}, got {got}")
    del model

    cfg = load_config(name, {"data.batch_size_per_device": MAIN_BATCH})
    t0 = time.perf_counter()
    trainer = Trainer(cfg, seeded_model(cfg, device, train=True), device=device,
                      steps_per_epoch=117266 // MAIN_BATCH)
    log(f"{label} train path: f32 master weights, {cfg.backbone.dtype} compute, seeded init "
        f"in {time.perf_counter() - t0:.1f} s")
    batch = train_batch(MAIN_BATCH, (480, 640), torch.Generator().manual_seed(9), device)
    launches[f"{label}_train"] = drive_train(trainer, batch, train_counters, card,
                                             f"{label} train path", None, "")[0]
    got = {k: n / TRAIN_STEPS for k, n in launches[f"{label}_train"].items()}
    if got != per_step:
        fail(f"{label} train path: expected launches per step {per_step}, got {got}")
    return launches


# --------------------------------------------------------------------------
# phase 16: the evaluation path


EVAL_IMAGES, VOC_IMAGES, FIT_IMAGES = 32, 16, 24


def check_eval_records(cpu, gpu, what: str) -> None:
    """The card's ``Evaluator`` records and tables against the CPU port's:
    labels equal, boxes within 1e-2 px, scores within 1e-4, every pasted
    mask's RLE IoU with the CPU one >= 0.99, each table's keys within 1e-3."""
    import numpy as np

    from mxdetection_tpu_torch.eval import rle

    (crecs, cres), (grecs, gres) = cpu, gpu
    grecs = {r["image_id"]: r for r in grecs}
    n, box_err, score_err, worst_iou, n_masks = 0, 0.0, 0.0, 1.0, 0
    for c in crecs:
        g = grecs[c["image_id"]]
        if not np.array_equal(c["labels"], g["labels"]):
            fail(f"{what}: image {c['image_id']} labels differ: {c['labels']} vs {g['labels']}")
        n += len(c["labels"])
        if len(c["labels"]):
            box_err = max(box_err, float(np.abs(c["boxes"] - g["boxes"]).max()))
            score_err = max(score_err, float(np.abs(c["scores"] - g["scores"]).max()))
        for a, b in zip(c["rles"] or [], g["rles"] or []):
            if rle.rle_area(a) or rle.rle_area(b):
                worst_iou = min(worst_iou, rle.rle_iou(a, b))
                n_masks += 1
    table_err = max(abs(cres[k] - gres[k]) for k in cres if k not in ("images_per_sec", "segm"))
    if "segm" in cres:
        table_err = max(table_err, *(abs(cres["segm"][k] - gres["segm"][k]) for k in cres["segm"]))
    log(f"{what} card vs CPU: {len(crecs)} images, {n} detections, max box err {box_err:.3e}, "
        f"max score err {score_err:.3e}, {n_masks} non-empty masks, least RLE IoU "
        f"{worst_iou:.4f}, max table err {table_err:.3e} (bounds 1e-2 px, 1e-4, 0.99, 1e-3)")
    if n == 0 or (cres.get("segm") is not None and n_masks == 0):
        fail(f"{what}: no detections (or no mask) to compare")
    if box_err > 1e-2 or score_err > 1e-4 or worst_iou < 0.99 or table_err > 1e-3:
        fail(f"{what}: the card's evaluation differs from the CPU port's")


def eval_parity(device, tmp: str) -> None:
    """Mask R-CNN's ``Evaluator`` on 2 synthetic images at 256x320 in f32,
    seeded weights, on the card (kernels) and on the CPU (plain versions)."""
    import os

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.data.coco import CocoDataset, make_synthetic_coco
    from mxdetection_tpu_torch.eval.evaluator import Evaluator

    ann, img_dir = make_synthetic_coco(os.path.join(tmp, "small"), num_images=2,
                                       size_range=(200, 300), num_classes=80, seed=3,
                                       split="val", min_objects=3)
    ds = CocoDataset(ann, img_dir, with_masks=True)
    cfg = load_config(MASK).override(**SMALL_OVERRIDES)
    out = []
    for dev in ("cpu", device):
        ev = Evaluator(cfg, seeded_model(cfg, "cpu").to(dev), ds, batch_size=2,
                       raw_hw=(320, 320), with_masks=True)
        res = ev.run(verbose=False)
        out.append((ev.records, res))
    check_eval_records(out[0], out[1], "eval small f32")


class CaptureTestNms:
    """While active, keeps the arguments of the first call of
    ``ops/nms.py::class_aware_nms_from_cfg`` (the postprocess reads it from
    its module at each call): the test NMS's candidates of a batch."""

    def __enter__(self):
        from mxdetection_tpu_torch.ops import nms as nms_lib

        self.module, self.orig, self.first = nms_lib, nms_lib.class_aware_nms_from_cfg, None
        inner = self.orig

        def wrapped(t, boxes, scores, labels, valid=None):
            if self.first is None:
                self.first = (boxes.clone(), scores.clone(), labels.clone())
            return inner(t, boxes, scores, labels, valid=valid)

        nms_lib.class_aware_nms_from_cfg = wrapped
        return self

    def __exit__(self, *exc):
        self.module.class_aware_nms_from_cfg = self.orig


def soft_nms_times(t, cand, card: str) -> dict:
    """Gaussian Soft-NMS (plain torch: 100 dependent picks), box voting,
    greedy class-aware NMS (K2 and its torch around it) and K2 alone on
    one batch's test-NMS candidates, by CUDA events."""
    import torch

    from mxdetection_tpu_torch.ops import nms as nms_lib
    from mxdetection_tpu_torch.ops.cuda.nms import nms_mask_sorted_cuda

    boxes, scores, labels = cand
    kw = dict(method="gaussian", iou_thr=t.nms_thr, sigma=t.soft_sigma, score_thr=t.score_thr)
    kept = nms_lib.class_aware_soft_nms(boxes, scores, labels, t.max_per_image, **kw)
    shifted = boxes + labels.to(boxes.dtype)[..., None] * nms_lib.class_offsets(boxes, None)
    valid, masked = nms_lib._mask_scores(scores, None, t.score_thr)
    _, order = nms_lib._sort_desc(masked)
    sorted_boxes = torch.gather(shifted, 1, order[..., None].expand(*order.shape, 4))
    sorted_valid = torch.gather(valid, 1, order)
    res = {
        "problems": list(boxes.shape[:2]),
        "soft_nms_ms": time_ms(lambda: nms_lib.class_aware_soft_nms(
            boxes, scores, labels, t.max_per_image, **kw)),
        "box_voting_ms": time_ms(lambda: nms_lib.box_voting(
            kept[0], kept[2], kept[3], boxes, scores, labels, t.vote_thr)),
        "greedy_nms_ms": time_ms(lambda: nms_lib.class_aware_nms(
            boxes, scores, labels, t.nms_thr, t.max_per_image, score_thr=t.score_thr)),
        "k2_ms": time_ms(lambda: nms_mask_sorted_cuda(sorted_boxes, sorted_valid, t.nms_thr)),
    }
    log(f"eval soft-NMS ({card}): on {res['problems'][0]} x {res['problems'][1]} candidates, "
        f"Gaussian Soft-NMS {res['soft_nms_ms']:.3f} ms, box voting {res['box_voting_ms']:.3f} "
        f"ms; greedy class-aware NMS {res['greedy_nms_ms']:.3f} ms, of which K2 "
        f"{res['k2_ms']:.3f} ms")
    return res


def run_eval(cfg, model, ds, counters, what: str, card: str, per_batch: dict | None = None,
             **kw) -> tuple:
    """``Evaluator.run`` with every launch count set to 0 just before and read
    just after; fails without detections or, given ``per_batch``, unless the
    launches a batch are those. Returns (launches, results, evaluator)."""
    import torch

    from mxdetection_tpu_torch.eval.evaluator import Evaluator

    ev = Evaluator(cfg, model, ds, batch_size=MAIN_BATCH, raw_hw=(640, 640), **kw)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ev.run(verbose=True)
    wall = time.perf_counter() - t0
    launches = {c.name: c.n for c in counters}
    n_batches = ev.loader.steps_per_epoch()
    n_dets = sum(len(r["labels"]) for r in ev.records)
    tm = ev.timing
    log(f"{what} ({card}): {res['num_images']} images in {n_batches} batches of {MAIN_BATCH} "
        f"({wall:.1f} s with the tables); steady state {tm['timed_images']} images in "
        f"{tm['timed_batches']} batches: {res['images_per_sec']:.2f} images/s, forward "
        f"{tm['forward_s']:.3f} s, paste + RLE {tm['paste_rle_s']:.3f} s; {n_dets} detections; "
        f"RLE codec {tm['rle']}, COCO matcher {tm['matcher']}; launches {launches}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n_dets == 0:
        fail(f"{what}: no detections")
    for name, n in launches.items():
        if n == 0:
            fail(f"{what} never launched the {name} kernel")
    if per_batch is not None:
        got = {k: n / n_batches for k, n in launches.items()}
        if got != per_batch:
            fail(f"{what}: expected launches per batch {per_batch}, got {got}")
    return launches, res, ev


def phase_eval_path(device, card: str, counters: list) -> tuple:
    """Phase 16 (see the module's docstring). Returns ({path: launches}, the
    Soft-NMS and K2 times of ``soft_nms_times``)."""
    import os
    import tempfile

    import torch

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.data.coco import CocoDataset, make_synthetic_coco
    from mxdetection_tpu_torch.data.voc import VocDataset, make_synthetic_voc
    from mxdetection_tpu_torch.eval import coco_eval, rle_native
    from mxdetection_tpu_torch.models.registry import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if rle_native.implementation() != "native" or coco_eval.native_matcher() is None:
        fail("the native RLE codec or COCO matcher did not build from native/ (see the log)")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        eval_parity(device, tmp)
        t0 = time.perf_counter()
        ann, img_dir = make_synthetic_coco(os.path.join(tmp, "coco"), num_images=EVAL_IMAGES,
                                           size_range=(400, 641), num_classes=80, seed=0,
                                           split="val", min_objects=3, max_objects=6)
        ds = CocoDataset(ann, img_dir, with_masks=True)
        log(f"eval path: {EVAL_IMAGES} synthetic images written and parsed in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = load_config(MASK)
        model = build_detector(cfg, device=device, seed=0)
        launches["eval_mask"] = run_eval(cfg, model, ds, counters, "eval mask path", card,
                                         {"roi_align": 2.0, "nms": 2.0}, with_masks=True)[0]
        del model

        cfg = load_config("faster_rcnn_r50_fpn_1x", {
            "test.nms_method": "soft_gaussian", "test.bbox_vote": True, "test.flip_tta": True,
            "test.scales_tta": (600,)})
        model = build_detector(cfg, device=device, seed=0)
        sub = CocoDataset(ann, img_dir)  # seed 0 has 16 landscape images: 2 batches
        sub.records = [r for r in sub.records if r.width >= r.height][:2 * MAIN_BATCH]
        with CaptureTestNms() as cap:
            launches["eval_soft_tta"], _, ev = run_eval(
                cfg, model, sub, counters, "eval Soft-NMS + box voting + TTA path", card)
        if len(ev.tta_variants) != 4 or ev.timing["timed_batches"] != 1:
            fail(f"eval TTA: {len(ev.tta_variants)} variants, "
                 f"{ev.timing['timed_batches']} timed batches (expected 4 and 1)")
        soft = soft_nms_times(cfg.test, cap.first, card)
        del model

        cfg = load_config("faster_rcnn_r50_voc")
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_images=VOC_IMAGES,
                                  size_range=(300, 501), seed=1, split=cfg.data.val_split)
        model = build_detector(cfg, device=device, seed=0)
        launches["eval_voc"] = run_eval(cfg, model, VocDataset(root, split=cfg.data.val_split),
                                         counters, "eval VOC path", card, {"roi_align": 1.0,
                                                                            "nms": 2.0},
                                         protocol="voc")[0]
    return launches, soft


# --------------------------------------------------------------------------
# phase 17: the training loop


def phase_fit_path(device, card: str, counters: list) -> dict:
    """Phase 17 (see the module's docstring). Returns {path: launches}."""
    import json
    import os
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.data.coco import CocoDataset, make_synthetic_coco
    from mxdetection_tpu_torch.data.loader import DetectionLoader
    from mxdetection_tpu_torch.train.checkpoint import CheckpointManager
    from mxdetection_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("faster_rcnn_r50_fpn_1x", {"data.batch_size_per_device": MAIN_BATCH})
    with tempfile.TemporaryDirectory() as tmp:
        # seed 2: 16 landscape and 8 portrait images, 3 full batches
        ann, img_dir = make_synthetic_coco(os.path.join(tmp, "train"), num_images=FIT_IMAGES,
                                           size_range=(400, 641), num_classes=80, seed=2,
                                           min_objects=3)
        loader = DetectionLoader(CocoDataset(ann, img_dir), batch_size=MAIN_BATCH,
                                 max_gt=cfg.data.max_gt, seed=cfg.train.seed,
                                 num_workers=cfg.data.num_workers, flip=True,
                                 orient_buckets=True)
        steps = loader.steps_per_epoch()
        t0 = time.perf_counter()
        n = sum(len(b["image_ids"]) for b in loader.epoch(0))
        loader_ips = n / (time.perf_counter() - t0)
        trainer = Trainer(cfg, device=device, seed=0, steps_per_epoch=steps)
        metrics_file = os.path.join(tmp, "metrics.jsonl")
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            history = trainer.fit_epochs(loader, 1, log_every=1, metrics_file=metrics_file)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {c.name: c.n for c in counters}
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        with open(metrics_file) as fh:
            lines = [json.loads(line) for line in fh]
        step_ms = [MAIN_BATCH * 1e3 / m["imgs_per_sec"] for m in history]
        log(f"fit_epochs path ({card}): {len(history)} steps of {MAIN_BATCH} over "
            f"{FIT_IMAGES} images in {wall_ms:.1f} ms under torch.profiler; ms per step "
            + ", ".join(f"{ms:.1f}" for ms in step_ms)
            + f" (the first pays the warm-up); device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}; the loader alone {loader_ips:.1f} images/s "
            f"({cfg.data.num_workers} workers), the loop "
            f"{MAIN_BATCH * len(history) * 1e3 / wall_ms:.1f} images/s; losses "
            + ", ".join(f"{m['loss']:.4f}" for m in history) + f"; launches {launches}")
        if len(history) != steps or lines != history or not all(
                torch.isfinite(torch.tensor(m["loss"])) for m in history):
            fail(f"fit_epochs: {len(history)} logged steps of {steps}, {len(lines)} metrics "
                 "lines, or a loss not finite")
        for name, k in launches.items():
            if k == 0:
                fail(f"fit_epochs never launched the {name} kernel")
        ckpt_dir = os.path.join(tmp, "ckpt")
        CheckpointManager(ckpt_dir).save(trainer, force=True)
        del trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "mxdetection_tpu_torch.tools.eval",
                              "--config", "faster_rcnn_r50_fpn_1x", "--checkpoint", ckpt_dir,
                              "--synthetic", "8"], capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in res.stdout.strip().splitlines():
            log(f"  tools.eval: {line}")
        log(f"tools.eval from the checkpoint: exit {res.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if res.returncode != 0 or "Average Precision  (AP)" not in res.stdout:
            fail(f"tools.eval --checkpoint failed:\n{res.stderr[-3000:]}")
    return {"fit_epochs": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="after the checks, split a batch into its stages and trace "
                             "it with torch.profiler into DIR")
    parser.add_argument("--k3-rois", metavar="FILE", default=None,
                        help="save the RoIAlign backward's two roi sets (phase 5's and one "
                             "training step's) to FILE, for ops/cuda/k3_variants.py and "
                             "ops/cuda/k1_variants.py")
    parser.add_argument("--k2-boxes", metavar="FILE", default=None,
                        help="save the problems K2 was handed in the first Faster R-CNN "
                             "inference batch and training step to FILE, for "
                             "ops/cuda/k2_variants.py --boxes")
    parser.add_argument("--baseline", metavar="DIR", default=None,
                        help="also run the RoIAlign forward kernel of the checkout DIR on "
                             "phase 2's inputs and log its largest difference and time")
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
    k1 = phase_roi_align(device, args.baseline)
    k2 = phase_nms(device)
    k4 = phase_iou(device)
    k3 = phase_roi_align_bwd(device)

    from mxdetection_tpu_torch.ops.cuda import deform_conv as dcn_cuda
    from mxdetection_tpu_torch.ops.cuda import iou as iou_cuda
    from mxdetection_tpu_torch.ops.cuda import nms as nms_cuda
    from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda

    # The Faster R-CNN path runs right after the kernel checks it ran after
    # before the cascade's phases existed, so its times stay comparable.
    nms_inference, nms_train = CaptureNms(2), CaptureNms(1)
    paths = {"inference": phase_main_path(device, card, [roi_cuda.launch_count,
                                                         nms_cuda.launch_count], args.profile,
                                          nms_inference)}
    k5 = phase_deform_conv(device)
    paths["cascade_inference"] = phase_cascade_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count, dcn_cuda.launch_count,
        dcn_cuda.s2_launch_count], args.profile)
    capture = CaptureRoi()
    paths["train"], faster_ms, faster_peak = phase_train_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
        roi_cuda.bwd_bf16_launch_count, iou_cuda.launch_count, iou_cuda.pass_a_count,
        iou_cuda.pass_b_count], args.profile, capture, nms_train)
    phase_roi_align_bwd_train(device, capture.first, k3, k1)
    nms_sets = dict(zip(("faster_rpn", "faster_class_aware", "train_rpn"),
                        nms_inference.calls + nms_train.calls))
    if len(nms_sets) != 3:
        fail(f"K2 was handed {len(nms_inference.calls)} problem sets in a Faster R-CNN batch "
             f"and {len(nms_train.calls)} in a training step, expected 2 and 1")
    k2["main_path_proposals"] = phase_nms_proposals(nms_sets)
    if args.k2_boxes:
        torch.save({name: (b.cpu(), v.cpu(), thr) for name, (b, v, thr) in nms_sets.items()},
                   args.k2_boxes)
        log(f"K2's main-path problems saved to {args.k2_boxes}")
    if args.k3_rois:
        torch.save({"shapes": k3["shapes"], "strides": k3["strides"], "sets": {
            "synthetic": k3["rois"], "train_step": k3["train_step"]["rois"]}}, args.k3_rois)
        log(f"K3's roi sets saved to {args.k3_rois}")
    k67 = phase_deform_conv_bwd(device)
    paths["cascade_train"] = phase_cascade_train_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
        roi_cuda.bwd_bf16_launch_count, iou_cuda.launch_count, iou_cuda.pass_a_count,
        iou_cuda.pass_b_count, dcn_cuda.launch_count,
        dcn_cuda.s2_launch_count, dcn_cuda.wgrad_launch_count,
        dcn_cuda.wgrad_s2_launch_count, dcn_cuda.col2im_launch_count,
        dcn_cuda.col2im_s2_launch_count], args.profile)
    paths["sync_bn_train"] = phase_sync_bn_train_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
        roi_cuda.bwd_bf16_launch_count, iou_cuda.launch_count, iou_cuda.pass_a_count,
        iou_cuda.pass_b_count], args.profile, (faster_ms, faster_peak))
    mask_paths, k1["p14"], k3["p14"] = phase_mask_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count], [
        roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
        roi_cuda.bwd_bf16_launch_count, iou_cuda.launch_count, iou_cuda.pass_a_count,
        iou_cuda.pass_b_count], args.profile)
    paths.update(mask_paths)
    k4_counters = [iou_cuda.launch_count, iou_cuda.pass_a_count, iou_cuda.pass_b_count]
    paths.update(phase_zoo_path(
        device, card, "retinanet_r50_fpn_1x", "retinanet", [nms_cuda.launch_count], k4_counters,
        {"nms": 1.0}, {"iou": 2.0, "iou_pass_a": 1.0, "iou_pass_b": 1.0}))
    rfcn_nms = CaptureNms(1)
    paths.update(phase_zoo_path(
        device, card, "rfcn_r50_1x", "rfcn", [nms_cuda.launch_count],
        [nms_cuda.launch_count, *k4_counters], {"nms": 2.0},
        {"nms": 1.0, "iou": 3.0, "iou_pass_a": 2.0, "iou_pass_b": 1.0},
        # OHEM selective at the small step's 32 rois, as in its train fixture
        train_overrides={"bbox_head.ohem_keep": 16}, nms_capture=rfcn_nms))
    boxes, valid, thr = rfcn_nms.calls[0]
    k2["rfcn_rpn"]["main_path"] = k2_case("rfcn_rpn first batch", thr, boxes, valid)
    t0 = time.perf_counter()
    eval_paths, soft_nms = phase_eval_path(device, card, [roi_cuda.launch_count,
                                                          nms_cuda.launch_count])
    paths.update(eval_paths)
    t1 = time.perf_counter()
    paths.update(phase_fit_path(device, card, [
        roi_cuda.launch_count, nms_cuda.launch_count, roi_cuda.bwd_launch_count,
        roi_cuda.bwd_bf16_launch_count, iou_cuda.launch_count, iou_cuda.pass_a_count,
        iou_cuda.pass_b_count]))
    log(f"phase 16 (evaluation) took {t1 - t0:.1f} s, phase 17 (training loop) "
        f"{time.perf_counter() - t1:.1f} s")

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

    def p14(res, extra):
        """P = 14 record: bf16 times, f32 error, bound, and what else it carries."""
        return {"ms": res["bfloat16"]["ms"], "plain_ms": res["bfloat16"]["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "max_abs_err": res["float32"]["max_abs_err"],
                **{k: v for k, v in res.items() if k in extra}}

    kernels = [
        # K1's times are of bf16 at phase 2's 8 x 1000 rois; beside them its time
        # at one training step's rois and the bytes its taps gather
        {**entry("roi_align_fwd", "roi_align.cu", K1_REPLACES, "roi_align", k1_err,
                 k1["bfloat16"]),
         "train_step_rois": k1["train_step"], "gathered_bytes": k1["gathered_bytes"],
         "l2_copy_tb_s": k1["l2_copy_tb_s"],
         "p14": p14(k1["p14"], ("gathered_bytes", "mask_detections", "mask_train_step"))},
        # K2's times are at phase 3's three shapes; beside them its time, bound
        # and shares on the problems of a Faster batch and training step
        {**entry("nms_mask_sorted", "nms.cu", K2_REPLACES, "nms", k2),
         "main_path_proposals": {name: {k: v for k, v in case.items() if k != "max_abs_err"}
                                 for name, case in k2["main_path_proposals"].items()},
         # R-FCN's RPN problem: 8 x N = 6000, synthetic and the first batch's own
         "rfcn_rpn": k2["rfcn_rpn"],
         # the eval path's test NMS: K2 beside Gaussian Soft-NMS (plain torch)
         # on one TTA variant's candidates
         "eval_soft_nms": soft_nms},
        # K3's times are of bf16 g and gradients at phase 5's rois; beside
        # them its time, pairs and longest list at one training step's rois
        {**entry("roi_align_bwd", "roi_align_bwd.cu", K3_REPLACES, "roi_align_bwd", k3_err,
                 k3["bfloat16"]),
         "pairs": k3["pairs"], "longest_list": k3["longest_list"],
         "train_step_rois": {k: v for k, v in k3["train_step"].items() if k != "rois"},
         "p14": {**p14(k3["p14"], ("pairs", "longest_list", "unstaged_pairs", "unstaged_rois")),
                 "mask_train_step": {k: v for k, v in k3["p14"]["mask_train_step"].items()
                                     if k != "rois"}}},
        # K3b is K3's bf16 epilogue: its launches are K3's with bf16 gradients
        {**entry("f32_to_bf16", "roi_align_bwd.cu", K3B_REPLACES, "roi_align_bwd_bf16",
                 k3["k3b"]), "fused_into": "roi_align_bwd"},
        # K4 is the max-IoU assigner: its time is the RPN route's (pass A +
        # pass B) at 8 x 279,279 x 100; the launches of each pass beside
        {**entry("max_iou_assign", "iou.cu", K4_REPLACES, "iou", k4),
         "launches_pass_a": sum(n.get("iou_pass_a", 0) for n in paths.values()),
         "launches_pass_b": sum(n.get("iou_pass_b", 0) for n in paths.values()),
         "overlap_pairs": k4["overlap_pairs"], "peak_mib": k4["peak_mib"],
         "row_max_ms": {k: k4[k]["ms"] for k in ("sample_rois", "relabel_rois")},
         # the route at RetinaNet's assignment, 8 x 209,538 x 100
         "retinanet_route": {k: v for k, v in k4["retinanet"].items() if k != "max_abs_err"}},
        # times, bounds and cuDNN's F.conv2d yardstick are per batch of the
        # cascade path: the sum over its DCN layers of each shape
        {**entry("deform_conv", "deform_conv.cu", K5_REPLACES, "deform_conv", k5[1]),
         "by_shape": k5[1]["by_shape"]},
        {**entry("deform_conv_s2", "deform_conv.cu", K5B_REPLACES, "deform_conv_s2", k5[2]),
         "by_shape": k5[2]["by_shape"]},
        # per step of the cascade training path; library_ms is cuDNN's wgrad
        # (beside K6) and dgrad (beside K7) of the same shapes
    ] + [{**entry(name, "deform_conv_bwd.cu", replaces, name, k67[key]),
          "by_shape": k67[key]["by_shape"],
          **{k: v for k, v in k67[key].items() if k == "spill_checks"}}
         for name, replaces, key in (
              ("deform_wgrad_doffsets", K6_REPLACES, ("k6", 1)),
              ("deform_wgrad_doffsets_s2", K6B_REPLACES, ("k6", 2)),
              ("deform_col2im", K7_REPLACES, ("k7", 1)),
              ("deform_col2im_s2", K7B_REPLACES, ("k7", 2)))]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
