"""Training throughput of a zoo config on the card — port of the JAX side's
``tools/bench_train.py``: the full training step on a synthetic batch
already on the device, in steps/s and images/s per card.

    python -m mxdetection_tpu_torch.tools.bench_train [config] [batch_per_device] \
        [dotted.key=value ...] [--device cpu]

Prints one JSON line on stdout: ``metric`` (``<config name>_train_step_per_sec``),
``value``, ``unit``, ``images_per_sec_per_chip``, ``global_batch`` and
``device``, the card's name; the log (the losses, peak memory, the
precision flags, the launches of every kernel over the timed steps) goes to
stderr.

The batch is the JAX tool's, array for array (``train_batch``):
``RandomState(0)`` canvases of 640x640 holding 480x640 images, two gt boxes
an image, label 0, no flip, and for Mask R-CNN a box mask per gt. It is
moved to the device once, as the JAX tool times "the step program only".
One warm-up ``Trainer.run_step``, then 10 timed steps; their losses (0-d
tensors on the device, no host sync in the step) are read on the host at
the end, inside the timed span. Precision is torch's default: the tool sets
no flag.

One process drives one card. Under ``python -m torch.distributed.run
--nproc_per_node N`` each rank joins the launcher's process group
(``tools/common.py::process_group``; a group the caller started itself is
used as it is): then the global batch is ``batch_per_device`` times the
group's size, each rank steps on its own rows, and rank 0 prints the line.
Without a group SyncBN's statistics are the one card's
(``multihost_dp_faster_rcnn_v5p16`` trains at world size 1).

The weights are ``tools/common.py::seeded_model``'s; for Cascade R-CNN the
offset convs get seeded noise from the batch's own canvases (generator
seed 11), as ``bench_infer`` does and for the same reason.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config
from ..ops.cuda import read_launches, reset_launches
from ..parallel.mesh import rank, world_size
from ..train.trainer import Trainer
from .common import (bench_log, dcn_layers, device_name, log_run_facts, parse_overrides,
                     process_group, seed_offset_convs, seeded_model)

WARMUP, ITERS = 1, 10


def train_batch(batch_size: int, max_gt: int, with_masks: bool) -> dict:
    """The JAX tool's synthetic training batch, as numpy arrays."""
    rng = np.random.RandomState(0)
    g = max_gt
    batch = {
        "raw": rng.randint(0, 255, (batch_size, 640, 640, 3)).astype(np.uint8),
        "hw": np.asarray([[480.0, 640.0]] * batch_size, np.float32),
        "flip": np.zeros((batch_size,), bool),
        "gt_boxes": np.tile(np.asarray(
            [[[50.0, 60, 300, 280], [200, 100, 500, 400]] + [[0, 0, 0, 0]] * (g - 2)],
            np.float32), (batch_size, 1, 1)),
        "gt_labels": np.zeros((batch_size, g), np.int32),
        "gt_valid": np.tile(np.asarray([[True, True] + [False] * (g - 2)]), (batch_size, 1)),
    }
    if with_masks:
        bm = np.zeros((batch_size, g, 28, 28), np.uint8)
        bm[:, :2, 4:24, 4:24] = 1
        batch["box_masks"] = bm
    return batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Training-step throughput of a zoo config.")
    ap.add_argument("config", nargs="?", default="faster_rcnn_r50_fpn_1x",
                    help="zoo name or configs/<name>.py")
    ap.add_argument("batch_per_device", nargs="?", type=int, default=2)
    ap.add_argument("overrides", nargs="*", help="dotted.key=value ...")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.overrides))
    with process_group(args.device) as device:
        run(cfg, args.batch_per_device, device)
    return 0


def run(cfg, bpd: int, device: torch.device) -> None:
    """One warm-up and ``ITERS`` timed steps of ``cfg`` at ``bpd`` images a
    device on this rank's rows of the batch; the log on stderr and, on
    rank 0, the JSON line."""
    n_rep, r = world_size(), rank()
    batch_size = bpd * n_rep
    batch = {k: torch.from_numpy(v[r * bpd:(r + 1) * bpd]).to(device)
             for k, v in train_batch(batch_size, cfg.data.max_gt,
                                     cfg.mask_head is not None).items()}
    model = seeded_model(cfg, device, train=True)
    if dcn_layers(model):
        seed_offset_convs(model, cfg, batch["raw"], batch["hw"], torch.Generator().manual_seed(11))
    trainer = Trainer(cfg, model, device=device, steps_per_epoch=1000)
    bench_log(f"{cfg.name}: {bpd} images a device x {n_rep} devices, "
              f"{cfg.data.pad_h}x{cfg.data.pad_w}, {cfg.backbone.dtype}, "
              f"on {device_name(device)}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(WARMUP):
        trainer.run_step(batch)["loss"].item()
    reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.run_step(batch)["loss"] for _ in range(ITERS)]
    losses = torch.stack(losses).cpu()
    dt = time.perf_counter() - t0
    launches = read_launches()

    bench_log(f"losses {', '.join(f'{v:.4f}' for v in losses.tolist())}; {ITERS} steps in "
              f"{dt * 1e3:.1f} ms, {dt * 1e3 / ITERS:.2f} ms a step")
    log_run_facts(device, launches)
    if not torch.isfinite(losses).all():
        raise SystemExit(f"{cfg.name}: a loss is not finite")
    steps_per_sec = ITERS / dt
    if r == 0:
        print(json.dumps({
            "metric": f"{cfg.name}_train_step_per_sec",
            "value": round(steps_per_sec, 3),
            "unit": "steps/sec",
            "images_per_sec_per_chip": round(steps_per_sec * batch_size / n_rep, 2),
            "global_batch": batch_size,
            "device": device_name(device),
        }), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
