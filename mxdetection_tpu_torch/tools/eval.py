"""Evaluation CLI of the port: a checkpoint -> the COCO table (or VOC mAP):

    python -m mxdetection_tpu_torch.tools.eval --config faster_rcnn_r50_fpn_1x \
        [--checkpoint output/faster_rcnn_r50_fpn_1x/ckpt] [--synthetic N] \
        [--batch-size 8] [--override ...] [--device cpu]

Runs on the card unless ``--device cpu``. ``--checkpoint DIR`` loads the
model weights of ``tools.train``'s latest checkpoint there; without it the
weights are seeded (``cfg.train.seed``). ``--synthetic N`` evaluates N
generated images, written to a temporary directory, instead of the
config's validation split.

Under ``python -m torch.distributed.run --nproc_per_node N`` each rank
joins the launcher's process group (``tools/common.py::process_group``),
evaluates its shard of the images and gathers every rank's detections, so
every rank computes the same table; rank 0 prints it. Every rank logs the
table's numbers as one ``results {json}`` line on stderr.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from ..config import load_config
from ..eval.evaluator import Evaluator
from ..models.registry import build_detector
from ..parallel.mesh import rank, world_size
from ..train.checkpoint import CheckpointManager
from .common import bench_log, load_dataset, parse_overrides, process_group


def _plain(v):
    """numpy values of the results as JSON's numbers and lists."""
    return v.tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate a detector of the zoo.")
    ap.add_argument("--config", required=True, help="zoo name or configs/<name>.py")
    ap.add_argument("--override", nargs="*", default=[], help="dotted.key=value ...")
    ap.add_argument("--checkpoint", default=None, help="directory of tools.train's checkpoints")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.override))
    with process_group(args.device) as device:
        writer = rank() == 0
        model = build_detector(cfg, device=device, seed=cfg.train.seed)
        if args.checkpoint:
            step = CheckpointManager(args.checkpoint).load_model(model)
            if writer:
                print(f"weights of step {step} from {args.checkpoint}")
        with tempfile.TemporaryDirectory() as tmp:
            # a temporary directory of each rank's own: each writes its set
            ds = load_dataset(cfg, cfg.data.val_split, args.synthetic, tmp, shared=False)
            ev = Evaluator(cfg, model, ds, batch_size=args.batch_size,
                           with_masks=cfg.mask_head is not None,
                           protocol="voc" if cfg.data.dataset == "voc" else "coco")
            results = ev.run(verbose=writer)
        bench_log(f"rank {rank()} of {world_size()}: results "
                  f"{json.dumps(results, default=_plain)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
