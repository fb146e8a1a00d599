"""Frozen-dataclass config tree — the port's own copy of
``mxdetection_tpu.config.core``.

Every hyperparameter is a field on an immutable dataclass; a config is built
by a zoo entry (``zoo.py``) and changed by dotted-path overrides:
``cfg.override(**{"train.optim.base_lr": 0.01})``. The fields and their
defaults are those of the JAX package, so one zoo name gives the same
config in both packages (a CPU test holds them field for field).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Tuple


def _tup(*xs):
    return field(default_factory=lambda: tuple(xs))


@dataclass(frozen=True)
class BackboneCfg:
    depth: int = 50                       # 50 | 101
    num_stages: int = 4
    frozen_stages: int = 1                # stem + stage1 frozen (family default)
    norm: str = "frozen_bn"               # frozen_bn | sync_bn | bn | gn
    dcn_stages: Tuple[bool, ...] = _tup(False, False, False, False)
    dtype: str = "bfloat16"               # compute dtype; params stay fp32
    remat: bool = False                   # recompute backbone blocks in the backward
    dilated_c5: bool = False              # R-FCN: layer4 at stride 1, dilation 2


@dataclass(frozen=True)
class FPNCfg:
    out_channels: int = 256
    min_level: int = 2                    # P2 for R-CNN, 3 for RetinaNet
    max_level: int = 6                    # P6 (P7 for RetinaNet)
    extra_convs: str = "pool"             # "pool" (R-CNN P6) | "conv" (Retina P6/P7)


@dataclass(frozen=True)
class AnchorCfg:
    strides: Tuple[int, ...] = _tup(4, 8, 16, 32, 64)
    scales: Tuple[float, ...] = _tup(8.0)
    ratios: Tuple[float, ...] = _tup(0.5, 1.0, 2.0)


@dataclass(frozen=True)
class RpnCfg:
    anchor: AnchorCfg = AnchorCfg()
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    batch_size: int = 256                 # sampled anchors per image
    pos_fraction: float = 0.5
    pre_nms_top_n_train: int = 2000       # per level (FPN convention)
    post_nms_top_n_train: int = 1000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_test: int = 1000
    nms_thr: float = 0.7
    min_box_size: float = 0.0
    loss_weight: float = 1.0
    bbox_stds: Tuple[float, ...] = _tup(1.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class RoiCfg:
    output_size: int = 7
    sampling_ratio: int = 2
    canonical_scale: float = 224.0
    canonical_level: int = 4
    min_level: int = 2
    max_level: int = 5                    # RoI features come from P2-P5


@dataclass(frozen=True)
class BboxHeadCfg:
    num_classes: int = 80                 # foreground classes (COCO)
    fc_channels: int = 1024
    num_samples: int = 512                # rois per image fed to the head
    pos_fraction: float = 0.25
    pos_iou_thr: float = 0.5
    neg_iou_thr_hi: float = 0.5
    neg_iou_thr_lo: float = 0.0
    bbox_stds: Tuple[float, ...] = _tup(0.1, 0.1, 0.2, 0.2)
    class_agnostic: bool = False
    loss_bbox_weight: float = 1.0
    smooth_l1_beta: float = 1.0
    ohem: bool = False                    # backprop only the ohem_keep hardest rois
    ohem_keep: int = 128


@dataclass(frozen=True)
class MaskHeadCfg:
    num_convs: int = 4
    channels: int = 256
    mask_size: int = 28
    roi_output_size: int = 14
    loss_weight: float = 1.0


@dataclass(frozen=True)
class RetinaHeadCfg:
    num_classes: int = 80
    stacked_convs: int = 4
    channels: int = 256
    octave_base_scale: float = 4.0
    scales_per_octave: int = 3
    ratios: Tuple[float, ...] = _tup(0.5, 1.0, 2.0)
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    prior_prob: float = 0.01
    bbox_stds: Tuple[float, ...] = _tup(1.0, 1.0, 1.0, 1.0)
    smooth_l1_beta: float = 0.11


@dataclass(frozen=True)
class RfcnHeadCfg:
    ps_grid: int = 7                      # k: k*k position-sensitive bins
    reduce_channels: int = 1024
    deform_pool: bool = False
    trans_std: float = 0.1


@dataclass(frozen=True)
class CascadeCfg:
    num_stages: int = 3
    stage_iou_thrs: Tuple[float, ...] = _tup(0.5, 0.6, 0.7)
    stage_bbox_stds: Tuple[Tuple[float, ...], ...] = field(
        default_factory=lambda: ((0.1, 0.1, 0.2, 0.2),
                                 (0.05, 0.05, 0.1, 0.1),
                                 (0.033, 0.033, 0.067, 0.067)))
    stage_loss_weights: Tuple[float, ...] = _tup(1.0, 0.5, 0.25)


@dataclass(frozen=True)
class DataCfg:
    dataset: str = "coco"                 # "coco" | "voc"
    root: str = "data/coco"
    train_split: str = "train2017"
    val_split: str = "val2017"
    voc_year: str = "2007"
    voc_metric_07: bool = False
    scale: int = 800                      # short side
    train_scales: Tuple[int, ...] = _tup()  # multi-scale training short sides
    max_size: int = 1333                  # long-side cap
    pad_h: int = 832
    pad_w: int = 1344
    flip: bool = True
    mean: Tuple[float, ...] = _tup(123.675, 116.28, 103.53)
    std: Tuple[float, ...] = _tup(58.395, 57.12, 57.375)
    max_gt: int = 100                     # padded gt boxes per image
    mask_size: int = 28
    batch_size_per_device: int = 2
    num_workers: int = 4


@dataclass(frozen=True)
class OptimCfg:
    optimizer: str = "sgd"
    base_lr: float = 0.02                 # for global batch 16 (linear scaling)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: float = 35.0               # clip by global norm
    warmup_steps: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_decay_epochs: Tuple[int, ...] = _tup(8, 11)
    lr_decay_factor: float = 0.1
    total_epochs: int = 12


@dataclass(frozen=True)
class TrainCfg:
    optim: OptimCfg = OptimCfg()
    seed: int = 0
    log_every: int = 20
    checkpoint_every_steps: int = 5000
    checkpoint_dir: str = "output"
    mesh_shape: Tuple[int, ...] = _tup(-1, 1)   # (data, model); -1 = all devices
    sync_bn: bool = False


@dataclass(frozen=True)
class TestCfg:
    score_thr: float = 0.05
    nms_thr: float = 0.5
    max_per_image: int = 100
    pre_nms_per_class: int = 1000         # dets entering class-aware NMS
    nms_method: str = "greedy"            # greedy | soft_linear | soft_gaussian
    soft_sigma: float = 0.5
    bbox_vote: bool = False
    vote_thr: float = 0.8
    flip_tta: bool = False
    scales_tta: Tuple[int, ...] = _tup()
    exact_topk: bool = False


@dataclass(frozen=True)
class Config:
    """Root config. ``detector`` picks the meta-architecture."""

    name: str = "faster_rcnn_r50_fpn"
    detector: str = "faster_rcnn"         # faster_rcnn|mask_rcnn|cascade_rcnn|retinanet|rfcn
    backbone: BackboneCfg = BackboneCfg()
    fpn: FPNCfg = FPNCfg()
    rpn: RpnCfg = RpnCfg()
    roi: RoiCfg = RoiCfg()
    bbox_head: BboxHeadCfg = BboxHeadCfg()
    mask_head: MaskHeadCfg | None = None
    retina_head: RetinaHeadCfg | None = None
    rfcn_head: RfcnHeadCfg | None = None
    cascade: CascadeCfg | None = None
    data: DataCfg = DataCfg()
    train: TrainCfg = TrainCfg()
    test: TestCfg = TestCfg()

    def override(self, **dotted: Any) -> "Config":
        """Apply dotted-path overrides: cfg.override(**{"train.optim.base_lr": 0.01})."""
        out = self
        for path, value in dotted.items():
            out = _set_path(out, path.split("."), value)
        return out


def _set_path(obj, parts, value):
    if len(parts) == 1:
        f = {f.name: f for f in dataclasses.fields(obj)}[parts[0]]
        if value is not None and f.type in ("int", "float", "str", "bool"):
            value = {"int": int, "float": float, "str": str,
                     "bool": lambda v: v in (True, "true", "True", "1")}[f.type](value)
        return replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return replace(obj, **{parts[0]: _set_path(child, parts[1:], value)})
