"""Evaluation CLI of the port: a checkpoint -> the COCO table (or VOC mAP):

    python -m mxdetection_tpu_torch.tools.eval --config faster_rcnn_r50_fpn_1x \
        [--checkpoint output/faster_rcnn_r50_fpn_1x/ckpt] [--synthetic N] \
        [--batch-size 8] [--override ...] [--device cpu]

Runs on the card unless ``--device cpu``. ``--checkpoint DIR`` loads the
model weights of ``tools.train``'s latest checkpoint there; without it the
weights are seeded (``cfg.train.seed``). ``--synthetic N`` evaluates N
generated images, written to a temporary directory, instead of the
config's validation split.
"""

from __future__ import annotations

import argparse
import tempfile

from ..config import load_config
from ..eval.evaluator import Evaluator
from ..models.registry import build_detector, require_device
from ..train.checkpoint import CheckpointManager
from .common import load_dataset, parse_overrides


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
    device = require_device(args.device)
    model = build_detector(cfg, device=device, seed=cfg.train.seed)
    if args.checkpoint:
        step = CheckpointManager(args.checkpoint).load_model(model)
        print(f"weights of step {step} from {args.checkpoint}")
    with tempfile.TemporaryDirectory() as tmp:
        ds = load_dataset(cfg, cfg.data.val_split, args.synthetic, tmp)
        ev = Evaluator(cfg, model, ds, batch_size=args.batch_size,
                       with_masks=cfg.mask_head is not None,
                       protocol="voc" if cfg.data.dataset == "voc" else "coco")
        ev.run(verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
