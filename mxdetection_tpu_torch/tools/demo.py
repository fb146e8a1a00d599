"""Single-image demo of the port: detect, draw the boxes (and masks), write
the picture, print the detections:

    python -m mxdetection_tpu_torch.tools.demo --config faster_rcnn_r50_fpn_1x \
        --image in.ppm --out det.ppm [--checkpoint DIR] [--score-thr 0.3] [--device cpu]

PPM images are read and written without Pillow; other formats need it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import load_config
from ..data.images import read_image, write_image
from ..data.transforms import batch_transform
from ..eval.evaluator import paste_masks
from ..models.detectors.rcnn import mask_probs
from ..models.registry import build_detector, detector_fns, require_device
from ..train.checkpoint import CheckpointManager
from .common import parse_overrides

PALETTE = [(230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
           (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
           (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255)]


def draw_detections(image: np.ndarray, boxes, scores, labels, masks=None,
                    score_thr: float = 0.3) -> np.ndarray:
    """(H, W, 3) uint8 -> a copy with each detection at or above
    ``score_thr``: its mask blended in at 100/255, its box outlined 2 px."""
    img = image.astype(np.float32)
    h, w = img.shape[:2]
    for i in range(len(boxes)):
        if scores[i] < score_thr:
            continue
        color = np.asarray(PALETTE[int(labels[i]) % len(PALETTE)], np.float32)
        if masks is not None:
            img[masks[i]] += (color - img[masks[i]]) * (100 / 255)
        x1, y1, x2, y2 = (int(round(float(v))) for v in boxes[i])
        x1, x2 = np.clip((x1, x2), 0, w - 1)
        y1, y2 = np.clip((y1, y2), 0, h - 1)
        img[y1:y1 + 2, x1:x2 + 1] = img[max(y2 - 1, 0):y2 + 1, x1:x2 + 1] = color
        img[y1:y2 + 1, x1:x1 + 2] = img[y1:y2 + 1, max(x2 - 1, 0):x2 + 1] = color
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a detector on one image.")
    ap.add_argument("--config", required=True, help="zoo name or configs/<name>.py")
    ap.add_argument("--override", nargs="*", default=[], help="dotted.key=value ...")
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="demo_out.ppm")
    ap.add_argument("--checkpoint", default=None, help="directory of tools.train's checkpoints")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.override))
    d = cfg.data
    device = require_device(args.device)
    model = build_detector(cfg, device=device, seed=cfg.train.seed)
    if args.checkpoint:
        CheckpointManager(args.checkpoint).load_model(model)

    img = read_image(args.image)
    h, w = img.shape[:2]
    raw = np.zeros((1, -(-h // 64) * 64, -(-w // 64) * 64, 3), np.uint8)
    raw[0, :h, :w] = img
    pad_hw = (d.pad_h, d.pad_w)
    tb = batch_transform(
        torch.from_numpy(raw).to(device), torch.tensor([[h, w]], dtype=torch.float32,
                                                       device=device),
        torch.zeros(1, dtype=torch.bool, device=device), torch.zeros(1, 1, 4, device=device),
        out_hw=pad_hw, scale_size=d.scale, max_size=d.max_size, mean=d.mean, std=d.std,
        dtype=model.compute_dtype)
    out = model.forward_test(tb["images"], tb["im_info"])
    dets = detector_fns(cfg).postprocess(out, cfg, pad_hw, tb["im_info"])
    v = dets["valid"][0]
    boxes = dets["boxes"][0][v].cpu().numpy()
    scores = dets["scores"][0][v].cpu().numpy()
    labels = dets["labels"][0][v].cpu().numpy()
    masks = None
    if getattr(model, "mask_head", None) is not None:
        masks = paste_masks(mask_probs(model, out, dets, tb["im_info"])[0][v], boxes, h, w)

    write_image(args.out, draw_detections(img, boxes, scores, labels, masks=masks,
                                          score_thr=args.score_thr))
    shown = scores >= args.score_thr
    for b, s, lab in zip(boxes[shown], scores[shown], labels[shown]):
        print(f"label {int(lab)} score {s:.3f} box {np.round(b, 1).tolist()}")
    print(f"wrote {args.out} with {int(shown.sum())} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
