"""What the port's command-line tools share: ``--override`` parsing and the
dataset of a config (its COCO or VOC files, or a synthetic set)."""

from __future__ import annotations

import ast
import os

from ..config import Config
from ..data.coco import CocoDataset, make_synthetic_coco
from ..data.voc import VocDataset, make_synthetic_voc


def parse_overrides(pairs) -> dict:
    """``["a.b=1", "c=(1, 2)", "d=text"]`` -> {"a.b": 1, "c": (1, 2), "d": "text"}:
    a value that is a Python literal is parsed, any other stays a string."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        out[k] = v
    return out


def num_classes(cfg: Config) -> int:
    return (cfg.retina_head.num_classes if cfg.detector == "retinanet"
            else cfg.bbox_head.num_classes)


def load_dataset(cfg: Config, split: str, synthetic: int, synthetic_root: str):
    """The config's dataset for ``split``, or with ``synthetic`` > 0 that
    many generated images under ``synthetic_root``."""
    with_masks = cfg.mask_head is not None
    if cfg.data.dataset == "voc":
        root = cfg.data.root
        if synthetic:
            root = make_synthetic_voc(synthetic_root, num_images=synthetic,
                                      num_classes=min(num_classes(cfg), 20), split=split,
                                      year=cfg.data.voc_year)
        return VocDataset(root, split=split, year=cfg.data.voc_year)
    if synthetic:
        ann, img_dir = make_synthetic_coco(synthetic_root, num_images=synthetic, split=split,
                                           num_classes=num_classes(cfg))
        return CocoDataset(ann, img_dir, with_masks=with_masks)
    return CocoDataset(
        os.path.join(cfg.data.root, "annotations", f"instances_{split}.json"),
        os.path.join(cfg.data.root, split), with_masks=with_masks)
