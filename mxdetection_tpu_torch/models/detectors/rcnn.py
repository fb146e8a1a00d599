"""Faster R-CNN inference — port of the one-stage inference path of
``mxdetection_tpu.models.detectors.rcnn``.

ResNet -> FPN P2-P6 -> RPN -> proposals (per-level top-k, decode, clip, NMS,
merged top-k) -> multilevel RoIAlign 7x7 on P2-P5 -> 2fc bbox head; then
``rcnn_postprocess`` decodes per class and runs class-aware NMS. Training,
the cascade and the mask branch are ROADMAP Queue 1 items 9-13.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import Config

from ...ops import anchors as anchor_lib
from ...ops import boxes as box_lib
from ...ops import nms as nms_lib
from ...ops.proposals import generate_proposals
from ...ops.roi_align import multilevel_roi_align
from ..backbones.resnet import ResNet
from ..heads.bbox_head import BBoxHead
from ..heads.rpn import RPNHead
from ..necks.fpn import FPN


def rpn_anchor_cfg(cfg: Config) -> anchor_lib.AnchorGenerator:
    a = cfg.rpn.anchor
    return anchor_lib.AnchorGenerator(strides=a.strides, scales=a.scales, ratios=a.ratios)


def rpn_level_anchors(cfg: Config, pad_hw: tuple[int, int], device=None) -> list:
    gen = rpn_anchor_cfg(cfg)
    shapes = [(-(-pad_hw[0] // s), -(-pad_hw[1] // s)) for s in cfg.rpn.anchor.strides]
    return gen.per_level(shapes, device=device)


def _roi_strides(cfg: Config) -> list:
    return [2 ** lv for lv in range(cfg.roi.min_level, cfg.roi.max_level + 1)]


def batched_roi_align(pyramid: list, rois: torch.Tensor, valid: torch.Tensor, cfg: Config,
                      out_size: int) -> torch.Tensor:
    """pyramid: P[min..max] each (B, H, W, C); rois (B, S, 4) -> (B, S, P, P, C).

    Inference branch: the CUDA kernel on the card, the plain version on CPU.
    """
    r = cfg.roi
    feats = [f.contiguous() for f in pyramid[: r.max_level - r.min_level + 1]]
    return multilevel_roi_align(
        feats, rois, _roi_strides(cfg), output_size=out_size,
        sampling_ratio=r.sampling_ratio, min_level=r.min_level,
        canonical_scale=r.canonical_scale, canonical_level=r.canonical_level,
        roi_valid=valid)


class RCNN(nn.Module):
    """One-stage Faster R-CNN (FPN), inference. Parameter names follow the
    JAX module tree, so ``utils/convert.py`` maps a flax checkpoint 1:1."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        if c.detector != "faster_rcnn" or c.cascade or c.mask_head is not None:
            raise NotImplementedError(f"detector {c.detector!r} is not ported yet "
                                      "(ROADMAP Queue 1 items 11-14)")
        self.cfg = cfg
        self.backbone = ResNet(depth=c.backbone.depth, norm_kind=c.backbone.norm,
                               dcn_stages=c.backbone.dcn_stages,
                               dilated_c5=c.backbone.dilated_c5)
        self.fpn = FPN(out_channels=c.fpn.out_channels, min_level=c.fpn.min_level,
                       max_level=c.fpn.max_level, extra_convs=c.fpn.extra_convs)
        self.rpn = RPNHead(num_anchors=rpn_anchor_cfg(c).num_base_anchors,
                           channels=c.fpn.out_channels)
        p = c.roi.output_size
        self.bbox_head0 = BBoxHead(p * p * c.fpn.out_channels,
                                   num_classes=c.bbox_head.num_classes,
                                   fc_channels=c.bbox_head.fc_channels,
                                   class_agnostic=c.bbox_head.class_agnostic)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.backbone, self.fpn, self.rpn, self.bbox_head0):
            m.reset_parameters(gen)

    def extract(self, images: torch.Tensor) -> list:
        return self.fpn(self.backbone(images))

    @torch.no_grad()
    def forward_test(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        """images (B, H, W, 3) NHWC, im_info (B, 3) rows (h, w, scale)."""
        c = self.cfg
        b = images.shape[0]
        dtype = next(self.parameters()).dtype
        pyramid = self.extract(images.to(dtype))
        rpn_cls, rpn_reg = self.rpn(pyramid)

        pad_hw = (images.shape[1], images.shape[2])
        anchors = rpn_level_anchors(c, pad_hw, device=images.device)
        resized_hw = im_info[:, :2] * im_info[:, 2:3]
        rois, _, roi_valid = generate_proposals(
            rpn_cls, rpn_reg, anchors, resized_hw,
            pre_nms_top_n=c.rpn.pre_nms_top_n_test,
            post_nms_top_n=c.rpn.post_nms_top_n_test,
            nms_thr=c.rpn.nms_thr, min_box_size=c.rpn.min_box_size,
            bbox_stds=c.rpn.bbox_stds)

        roi_feats = batched_roi_align(pyramid, rois, roi_valid, c, c.roi.output_size)
        s = roi_feats.shape[1]
        cls_logits, deltas = self.bbox_head0(roi_feats.reshape(b * s, *roi_feats.shape[2:]))
        return {
            "pyramid": pyramid,
            "rois": rois, "roi_valid": roi_valid,
            "probs": torch.softmax(cls_logits.reshape(b, s, -1), dim=-1),
            "deltas": deltas.reshape(b, s, -1),
            "final_stds": c.bbox_head.bbox_stds,
            "class_agnostic": c.bbox_head.class_agnostic,
        }

    def forward(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        return self.forward_test(images, im_info)


@torch.no_grad()
def rcnn_postprocess(outputs: dict, cfg: Config, image_hw: tuple[int, int],
                     im_info: torch.Tensor) -> dict:
    """Decode + per-class NMS, batched over images. Returns fixed
    (B, max_per_image) detections in original image coordinates, labels
    0-based."""
    t = cfg.test
    num_classes = cfg.bbox_head.num_classes
    stds = outputs["final_stds"]
    rois, valid = outputs["rois"], outputs["roi_valid"]
    probs, deltas = outputs["probs"], outputs["deltas"]
    b, r = rois.shape[:2]
    resized_hw = (im_info[:, :2] * im_info[:, 2:3])[:, None, None, :]  # (B, 1, 1, 2)

    if outputs["class_agnostic"]:
        boxes = box_lib.decode_boxes(rois, deltas, stds=stds)
        boxes = box_lib.clip_boxes(boxes, resized_hw[:, 0])
        boxes_pc = boxes[:, :, None, :].expand(b, r, num_classes, 4)
    else:
        d = deltas.reshape(b, r, num_classes + 1, 4)
        boxes_pc = box_lib.decode_boxes(rois[:, :, None, :].expand(b, r, num_classes + 1, 4),
                                        d, stds=stds)
        boxes_pc = box_lib.clip_boxes(boxes_pc, resized_hw)[:, :, 1:, :]  # drop bg

    scores_pc = probs[..., 1:]
    flat_boxes = boxes_pc.reshape(b, r * num_classes, 4)
    flat_scores = torch.where(valid[..., None], scores_pc,
                              torch.zeros_like(scores_pc)).reshape(b, -1)
    flat_labels = torch.arange(num_classes, device=rois.device).repeat(r)

    k = min(t.pre_nms_per_class, flat_scores.shape[1])
    top_scores, idx = nms_lib.topk_stable(flat_scores, k)
    ob, os_, ol, ov = nms_lib.class_aware_nms_from_cfg(
        t, torch.gather(flat_boxes, 1, idx[..., None].expand(b, k, 4)), top_scores,
        flat_labels[idx])
    scale = im_info[:, 2][:, None, None]
    ob = box_lib.clip_boxes(ob / scale, im_info[:, None, :2])
    return {"boxes": ob, "scores": os_, "labels": ol, "valid": ov}
