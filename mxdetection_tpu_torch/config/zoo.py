"""The model zoo: one ``get()`` per ``configs/<name>.py`` of the repository.

The files under ``configs/`` build their configs from the JAX package's
classes, so the port never executes them; each entry here builds the same
config from the port's own classes (``core.py``). A CPU test holds every
entry against the JAX ``load_config`` of its file, field for field.
"""

from __future__ import annotations

from .core import (
    AnchorCfg, BackboneCfg, BboxHeadCfg, CascadeCfg, Config, DataCfg, MaskHeadCfg,
    OptimCfg, RetinaHeadCfg, RfcnHeadCfg, RpnCfg, TrainCfg, FPNCfg,
)


def faster_rcnn_r50_fpn_1x() -> Config:
    """Faster R-CNN R50-FPN 1x COCO."""
    return Config(name="faster_rcnn_r50_fpn_1x", detector="faster_rcnn")


def faster_rcnn_r50_voc() -> Config:
    """Faster R-CNN R50-FPN on PASCAL VOC: short side 600, long side 1000, 20 classes."""
    return Config(
        name="faster_rcnn_r50_voc",
        detector="faster_rcnn",
        backbone=BackboneCfg(depth=50),
        data=DataCfg(dataset="voc", root="data/VOCdevkit", train_split="trainval",
                     val_split="test", voc_year="2007", scale=600, max_size=1000,
                     pad_h=640, pad_w=1024),
        bbox_head=BboxHeadCfg(num_classes=20),
    )


def retinanet_r50_fpn_1x() -> Config:
    """RetinaNet R50-FPN 1x COCO."""
    return Config(
        name="retinanet_r50_fpn_1x",
        detector="retinanet",
        backbone=BackboneCfg(depth=50),
        fpn=FPNCfg(out_channels=256, min_level=3, max_level=7, extra_convs="conv"),
        retina_head=RetinaHeadCfg(),
    )


def mask_rcnn_r50_fpn_1x() -> Config:
    """Mask R-CNN R50-FPN 1x COCO."""
    return Config(name="mask_rcnn_r50_fpn_1x", detector="mask_rcnn", mask_head=MaskHeadCfg())


def cascade_rcnn_r101_dcn_1x() -> Config:
    """Cascade R-CNN R101 with deformable convs in stages 2-4."""
    return Config(
        name="cascade_rcnn_r101_dcn_1x",
        detector="cascade_rcnn",
        backbone=BackboneCfg(depth=101, dcn_stages=(False, True, True, True)),
        cascade=CascadeCfg(),
    )


def rfcn_r50_1x() -> Config:
    """R-FCN R50, dilated C5, deformable PSRoIPool, OHEM."""
    return Config(
        name="rfcn_r50_1x",
        detector="rfcn",
        backbone=BackboneCfg(depth=50, dilated_c5=True),
        rpn=RpnCfg(
            anchor=AnchorCfg(strides=(16,), scales=(4.0, 8.0, 16.0, 32.0),
                             ratios=(0.5, 1.0, 2.0)),
            pre_nms_top_n_train=6000, post_nms_top_n_train=300,
            pre_nms_top_n_test=6000, post_nms_top_n_test=300,
        ),
        bbox_head=BboxHeadCfg(num_samples=300, class_agnostic=True, ohem=True, ohem_keep=128),
        rfcn_head=RfcnHeadCfg(ps_grid=7, reduce_channels=1024, deform_pool=True),
    )


def multihost_dp_faster_rcnn_v5p16() -> Config:
    """Data-parallel Faster R-CNN with SyncBN, linear-scaled LR for global batch 32."""
    return Config(
        name="multihost_dp_faster_rcnn_v5p16",
        detector="faster_rcnn",
        backbone=BackboneCfg(norm="sync_bn", frozen_stages=-1),
        train=TrainCfg(sync_bn=True, mesh_shape=(-1, 1), optim=OptimCfg(base_lr=0.04)),
    )


ZOO = {f.__name__: f for f in (
    faster_rcnn_r50_fpn_1x, faster_rcnn_r50_voc, retinanet_r50_fpn_1x, mask_rcnn_r50_fpn_1x,
    cascade_rcnn_r101_dcn_1x, rfcn_r50_1x, multihost_dp_faster_rcnn_v5p16)}
