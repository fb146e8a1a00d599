"""Training CLI of the port:

    python -m mxdetection_tpu_torch.tools.train --config faster_rcnn_r50_fpn_1x \
        [--override train.optim.base_lr=0.01 data.root=/data/coco] \
        [--resume] [--epochs N] [--batch-size B] [--synthetic N] [--device cpu]

Trains on the card unless ``--device cpu``. ``--synthetic N`` trains on N
generated images (``make_synthetic_coco`` / ``make_synthetic_voc``) instead
of ``cfg.data.root``. The log, ``metrics.jsonl`` and the checkpoints
(``ckpt/step_<n>.pt``, which ``tools.eval --checkpoint`` reads) go to
``<train.checkpoint_dir>/<config name>/``.

Data parallelism, one process a card:

    python -m torch.distributed.run --nproc_per_node N \
        -m mxdetection_tpu_torch.tools.train --config multihost_dp_faster_rcnn_v5p16 ...

Each rank joins the launcher's process group (``tools/common.py::process_group``;
rank r on ``cuda:LOCAL_RANK``), steps ``data.batch_size_per_device``
(``--batch-size``) images of every global batch of N times that many (the
loader's shard), and the ``Trainer`` averages the gradients over the ranks.
Rank 0 alone writes the synthetic set (the others wait for it), the log
file, ``metrics.jsonl`` and the checkpoints; the other ranks log to stderr.
"""

from __future__ import annotations

import argparse
import os

from ..config import Config, load_config
from ..data.loader import DetectionLoader
from ..parallel.mesh import rank
from ..train.checkpoint import CheckpointManager
from ..train.trainer import Trainer
from ..utils.logger import create_logger
from .common import load_dataset, parse_overrides, process_group


def make_loader(cfg: Config, dataset, **kw) -> DetectionLoader:
    """The training loader of ``cfg`` over ``dataset``: this rank's shard
    of every global batch when a process group exists (``kw`` may name the
    shards instead)."""
    return DetectionLoader(
        dataset, batch_size=cfg.data.batch_size_per_device, max_gt=cfg.data.max_gt,
        seed=cfg.train.seed, num_workers=cfg.data.num_workers,
        with_masks=cfg.mask_head is not None, flip=cfg.data.flip,
        train_scales=cfg.data.train_scales, orient_buckets=True, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a detector of the zoo.")
    ap.add_argument("--config", required=True, help="zoo name or configs/<name>.py")
    ap.add_argument("--override", nargs="*", default=[], help="dotted.key=value ...")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None, help="images a step (per process)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic images instead of cfg.data.root")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.override)
    if args.batch_size:
        overrides["data.batch_size_per_device"] = args.batch_size
    cfg = load_config(args.config, overrides)
    with process_group(args.device) as device:
        writer = rank() == 0
        workdir = os.path.join(cfg.train.checkpoint_dir, cfg.name)
        logger = create_logger(workdir, to_file=writer)
        ds = load_dataset(cfg, cfg.data.train_split, args.synthetic,
                          os.path.join(workdir, "synthetic"))
        loader = make_loader(cfg, ds)
        logger.info("config: %s device: %s rank %d of %d, %d images a step of %d",
                    cfg.name, device, loader.shard_index, loader.num_shards,
                    loader.batch_size, loader.global_batch)
        trainer = Trainer(cfg, device=device, seed=cfg.train.seed,
                          steps_per_epoch=loader.steps_per_epoch(), logger=logger)
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"))
        if args.resume and ckpt.latest_step() is not None:
            logger.info("resumed from step %d", ckpt.restore(trainer))

        every = cfg.train.checkpoint_every_steps

        def on_metrics(m):
            if m["step"] % every == 0:
                ckpt.save(trainer)

        trainer.fit_epochs(loader, args.epochs or cfg.train.optim.total_epochs,
                           log_every=cfg.train.log_every, on_metrics=on_metrics,
                           metrics_file=os.path.join(workdir, "metrics.jsonl") if writer
                           else None)
        ckpt.save(trainer, force=True)
        logger.info("done at step %d; checkpoints in %s", trainer.optimizer.count,
                    ckpt.directory)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
