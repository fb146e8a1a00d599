"""Inference throughput of a zoo config on the card — port of the JAX side's
``bench.py`` (the headline) and ``tools/bench_infer.py`` (any config):

    python -m mxdetection_tpu_torch.tools.bench_infer [--config NAME] [--batch B] \
        [--override k=v ...] [--device cpu]

The defaults are the headline: Faster R-CNN R50-FPN COCO inference at batch
32 (832x1344 canvases, bf16). Prints exactly one JSON line on stdout. For
the headline config it has ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``) under the metric name
``faster_rcnn_r50_fpn_coco_inference_images_per_sec_per_gpu``, which no TPU
figure of the JAX side carries; for any other config
``tools/bench_infer.py``'s (``config``, ``batch``, ``images_per_sec``). Both
add ``device``, the card's name. The log (valid proposals and detections
of the last batch, peak memory, the precision flags, the launches of every
kernel over the timed batches) goes to stderr.

The input is the JAX tools': ``RandomState(0)`` uint8 canvases of 640x640
holding 480x640 images, no flip, no gt, moved to the device once. Each
batch is ``tools/common.py::infer_batch`` (transform, forward, the
detector's postprocess and, for Mask R-CNN, the mask probabilities of the
detections). Two batches run untimed; then 10 are enqueued back to back
with no synchronisation between them, and the wall time is taken around
that and the copy of all 10 batches' detections to the host, as
``jax.device_get(outs)`` in the JAX tools. Precision is torch's default:
the tool sets no flag.

The weights are ``tools/common.py::seeded_model``'s (seed 0, RetinaNet's and
R-FCN's class conv scaled; the module's docstring says why this deviates
from the JAX tools' init). For Cascade R-CNN the offset convs get seeded
noise (``seed_offset_convs``, generator seed 11, measured on the bench's
own canvases in one untimed batch), so K5 samples off the grid at offsets
of about one cell, as a trained net's DCN would; at the JAX init's zero
offsets it would time another load.

``vs_baseline`` (from ``bench.py``): the MXNet reference published no
numbers ("published": {}) and is not runnable here, so the denominator is
the family-standard published single-GPU throughput for this exact
architecture in the MXNet/Detectron era: ~12 images/sec (Detectron
model-zoo inference timing for e2e Faster R-CNN R50-FPN, ~80-90 ms/im on
P100/V100-class hardware; BASELINE.md). vs_baseline = ours / 12.0.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config
from ..models.registry import require_device
from ..ops.cuda import read_launches, reset_launches
from .common import (bench_log, dcn_layers, device_name, infer_batch, log_run_facts,
                     parse_overrides, seed_offset_convs, seeded_model)

REFERENCE_IMGS_PER_SEC = 12.0  # documented proxy denominator, see the module's docstring
HEADLINE = "faster_rcnn_r50_fpn_1x"
HEADLINE_METRIC = "faster_rcnn_r50_fpn_coco_inference_images_per_sec_per_gpu"
WARMUP, ITERS = 2, 10
DET_KEYS = ("boxes", "scores", "labels", "valid", "masks")


def synthetic_input(batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tools' input: (batch, 640, 640, 3) uint8 canvases from
    ``RandomState(0)`` and their image sizes, 480x640 each."""
    raw = np.random.RandomState(0).randint(0, 255, (batch, 640, 640, 3), np.uint8)
    return raw, np.asarray([[480.0, 640.0]] * batch, np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Inference throughput of a zoo config.")
    ap.add_argument("--config", default=HEADLINE, help="zoo name or configs/<name>.py")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--override", nargs="*", default=[], help="dotted.key=value ...")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.override))
    device = require_device(args.device)
    raw_np, hw_np = synthetic_input(args.batch)
    raw, hw = torch.from_numpy(raw_np).to(device), torch.from_numpy(hw_np).to(device)
    model = seeded_model(cfg, device)
    dtype = model.compute_dtype
    if dcn_layers(model):
        seed_offset_convs(model, cfg, raw, hw, torch.Generator().manual_seed(11))
    bench_log(f"{cfg.name}: batch {args.batch}, {cfg.data.pad_h}x{cfg.data.pad_w}, "
              f"{cfg.backbone.dtype}, on {device_name(device)}")

    def batch():
        dets, out = infer_batch(model, cfg, raw, hw, dtype)
        return {k: dets[k] for k in DET_KEYS if k in dets}, out

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(WARMUP):
        [t.cpu() for t in batch()[0].values()]
    reset_launches()
    t0 = time.perf_counter()
    outs = []
    for _ in range(ITERS):
        dets, out = batch()
        outs.append(dets)
    host = [{k: t.cpu() for k, t in dets.items()} for dets in outs]
    dt = time.perf_counter() - t0
    launches = read_launches()

    last = host[-1]
    proposals = (f"{int(out['roi_valid'].sum())}/{out['roi_valid'].numel()} valid proposals, "
                 if "roi_valid" in out else "no proposals (a dense head), ")
    bench_log(f"last batch: {proposals}{int(last['valid'].sum())}/{last['valid'].numel()} "
              f"valid detections; {ITERS} batches in {dt * 1e3:.1f} ms, "
              f"{dt * 1e3 / ITERS:.2f} ms a batch")
    log_run_facts(device, launches)
    images_per_sec = args.batch * ITERS / dt
    if cfg.name == HEADLINE:
        line = {"metric": HEADLINE_METRIC, "value": round(images_per_sec, 2),
                "unit": "images/sec/gpu",
                "vs_baseline": round(images_per_sec / REFERENCE_IMGS_PER_SEC, 2)}
    else:
        line = {"config": cfg.name, "batch": args.batch,
                "images_per_sec": round(images_per_sec, 2)}
    print(json.dumps({**line, "device": device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
