"""Faster R-CNN — port of the one-stage paths of
``mxdetection_tpu.models.detectors.rcnn``.

Inference: ResNet -> FPN P2-P6 -> RPN -> proposals (per-level top-k, decode,
clip, NMS, merged top-k) -> multilevel RoIAlign 7x7 on P2-P5 -> 2fc bbox
head; then ``rcnn_postprocess`` decodes per class and runs class-aware NMS.

Training (``forward_train`` + ``rcnn_loss``): the same trunk with the
training proposal counts, then ``sample_rois`` picks the second stage's
rois, RoIAlign (differentiable: K1 forward, K3 backward on the card) feeds
the bbox head, and the loss assigns anchors to gt (``assign_max_iou``,
K4's IoU) and subsamples them. The random draws of the two samplers come
from an injectable source (``ops/matching.py``). The cascade, the mask
branch and OHEM are ROADMAP Queue 1 items 11, 13 and 14.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import Config

from ...losses.losses import smooth_l1_loss
from ...ops import anchors as anchor_lib
from ...ops import boxes as box_lib
from ...ops import matching
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

    One branch serves inference and training: on the card K1, with K3 (+ K3b)
    as its backward; on the CPU the plain version under torch autograd.
    """
    r = cfg.roi
    feats = [f.contiguous() for f in pyramid[: r.max_level - r.min_level + 1]]
    return multilevel_roi_align(
        feats, rois, _roi_strides(cfg), output_size=out_size,
        sampling_ratio=r.sampling_ratio, min_level=r.min_level,
        canonical_scale=r.canonical_scale, canonical_level=r.canonical_level,
        roi_valid=valid)


class RCNN(nn.Module):
    """One-stage Faster R-CNN (FPN). Parameter names follow the JAX module
    tree, so ``utils/convert.py`` maps a flax checkpoint 1:1. Computes in
    ``cfg.backbone.dtype`` whatever the dtype of its parameters."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        if c.detector != "faster_rcnn" or c.cascade or c.mask_head is not None:
            raise NotImplementedError(f"detector {c.detector!r} is not ported yet "
                                      "(ROADMAP Queue 1 items 11-14)")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, c.backbone.dtype)
        self.backbone = ResNet(depth=c.backbone.depth, norm_kind=c.backbone.norm,
                               frozen_stages=c.backbone.frozen_stages,
                               dcn_stages=c.backbone.dcn_stages,
                               dilated_c5=c.backbone.dilated_c5, remat=c.backbone.remat)
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
        pyramid = self.extract(images.to(self.compute_dtype))
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

    def forward_train(self, tb: dict, draws: matching.Draws) -> dict:
        """tb: images (B, H, W, 3), im_info (B, 3), gt_boxes (B, G, 4) in
        network coordinates, gt_labels (B, G) 0-based, gt_valid (B, G).
        Returns the stage-1 outputs and targets that ``rcnn_loss`` reads."""
        c = self.cfg
        images = tb["images"].to(self.compute_dtype)
        b = images.shape[0]
        pyramid = self.extract(images)
        rpn_cls, rpn_reg = self.rpn(pyramid)

        pad_hw = (images.shape[1], images.shape[2])
        anchors = rpn_level_anchors(c, pad_hw, device=images.device)
        resized_hw = tb["im_info"][:, :2] * tb["im_info"][:, 2:3]
        rois, _, roi_valid = generate_proposals(
            rpn_cls, rpn_reg, anchors, resized_hw,
            pre_nms_top_n=c.rpn.pre_nms_top_n_train,
            post_nms_top_n=c.rpn.post_nms_top_n_train,
            nms_thr=c.rpn.nms_thr, min_box_size=c.rpn.min_box_size,
            bbox_stds=c.rpn.bbox_stds)

        gt_boxes, gt_valid = tb["gt_boxes"].float(), tb["gt_valid"]
        gt_labels1 = torch.where(gt_valid, tb["gt_labels"] + 1, 0)
        h = c.bbox_head
        n = gt_boxes.shape[1] + rois.shape[1]
        sampled = matching.sample_rois(
            rois, roi_valid, gt_boxes, gt_labels1, gt_valid,
            matching.random_rank(draws, "sample_rois", b, n),
            num_samples=h.num_samples, pos_fraction=h.pos_fraction,
            pos_iou_thr=h.pos_iou_thr, neg_iou_thr_hi=h.neg_iou_thr_hi,
            neg_iou_thr_lo=h.neg_iou_thr_lo)

        roi_feats = batched_roi_align(pyramid, sampled.rois, sampled.valid_mask, c,
                                      c.roi.output_size)
        s = roi_feats.shape[1]
        cls_logits, deltas = self.bbox_head0(roi_feats.reshape(b * s, *roi_feats.shape[2:]))
        matched_gt = torch.gather(gt_boxes, 1, sampled.matched_gt[..., None].expand(b, s, 4))
        stage = {
            "cls_logits": cls_logits.reshape(b, s, -1), "deltas": deltas.reshape(b, s, -1),
            "labels": sampled.labels,
            "reg_targets": box_lib.encode_boxes(sampled.rois, matched_gt, stds=h.bbox_stds),
            "pos": sampled.pos_mask, "valid": sampled.valid_mask, "rois": sampled.rois,
        }
        return {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "stages": [stage], "pad_hw": pad_hw}


def rcnn_loss(outputs: dict, tb: dict, draws: matching.Draws, cfg: Config) -> tuple:
    """RPN + stage-1 losses of ``forward_train``'s outputs -> (total, metrics).

    The RPN assigns every anchor inside the resized image to gt (low-quality
    force on), subsamples ``rpn.batch_size`` of them, and takes BCE on the
    objectness and smooth-L1 (beta 1/9) on the positives' deltas; the second
    stage takes softmax CE over the sampled rois and smooth-L1 on the
    positives' class-specific deltas. Everything is f32, as the JAX loss.
    """
    c = cfg
    if c.bbox_head.ohem:
        raise NotImplementedError("bbox_head.ohem is not ported yet (ROADMAP Queue 1 item 14: "
                                  "R-FCN)")
    rpn_cls = torch.cat([o.reshape(o.shape[0], -1) for o in outputs["rpn_cls"]], 1).float()
    rpn_reg = torch.cat([o.reshape(o.shape[0], -1, 4) for o in outputs["rpn_reg"]], 1).float()
    b, n = rpn_cls.shape
    anchors = torch.cat(rpn_level_anchors(c, outputs["pad_hw"], device=rpn_cls.device), 0)
    gt_boxes, gt_valid = tb["gt_boxes"].float(), tb["gt_valid"]

    # anchors outside the valid resized region take no part (allowed_border=0)
    hw = (tb["im_info"][:, :2] * tb["im_info"][:, 2:3])[:, None, :]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] <= hw[..., 1]) & (anchors[None, :, 3] <= hw[..., 0]))
    res = matching.assign_max_iou(
        anchors.expand(b, n, 4), gt_boxes, gt_valid, pos_iou_thr=c.rpn.pos_iou_thr,
        neg_iou_thr=c.rpn.neg_iou_thr, match_low_quality=True, box_valid=inside)
    sample_mask, labels = matching.subsample_labels(
        res.labels, c.rpn.batch_size, c.rpn.pos_fraction,
        matching.random_rank(draws, "rpn", b, n))
    pos = sample_mask & (labels == 1)
    n_samp = sample_mask.sum(-1).clamp(min=1).float()

    tgt = pos.float()
    bce = -(tgt * F.logsigmoid(rpn_cls) + (1 - tgt) * F.logsigmoid(-rpn_cls))
    rpn_cls_loss = torch.where(sample_mask, bce, 0.0).sum(-1) / n_samp
    matched = torch.gather(gt_boxes, 1, res.matched_gt[..., None].expand(b, n, 4))
    reg_tgt = box_lib.encode_boxes(anchors[None], matched, stds=c.rpn.bbox_stds)
    l1 = smooth_l1_loss(rpn_reg, reg_tgt, beta=1.0 / 9.0)
    rpn_reg_loss = torch.where(pos[..., None], l1, 0.0).sum((1, 2)) / n_samp

    metrics = {"loss_rpn_cls": rpn_cls_loss.mean(), "loss_rpn_reg": rpn_reg_loss.mean()}
    total = (metrics["loss_rpn_cls"] + metrics["loss_rpn_reg"]) * c.rpn.loss_weight

    num_classes = c.bbox_head.num_classes
    for i, st in enumerate(outputs["stages"]):
        cls, labels_i, valid, pos_i = st["cls_logits"], st["labels"], st["valid"], st["pos"]
        safe = labels_i.long().clamp(0, num_classes)
        nll = -torch.gather(F.log_softmax(cls, dim=-1), -1, safe[..., None])[..., 0]
        nll = torch.where(valid, nll, 0.0)
        deltas = st["deltas"]
        if deltas.shape[-1] != 4:
            dr = deltas.reshape(*deltas.shape[:2], num_classes + 1, 4)
            deltas = torch.gather(dr, 2, safe[..., None, None].expand(*safe.shape, 1, 4))[:, :, 0]
        l1 = smooth_l1_loss(deltas, st["reg_targets"], beta=c.bbox_head.smooth_l1_beta).sum(-1)
        l1 = torch.where(pos_i, l1, 0.0)
        norm = valid.sum(-1).clamp(min=1).float()
        acc = torch.where(valid, cls.argmax(-1) == labels_i, False).sum(-1) / norm
        metrics[f"loss_rcnn_cls{i}"] = (nll.sum(-1) / norm).mean()
        metrics[f"loss_rcnn_reg{i}"] = (l1.sum(-1) / norm).mean() * c.bbox_head.loss_bbox_weight
        metrics[f"rcnn_acc{i}"] = acc.mean()
        total = total + metrics[f"loss_rcnn_cls{i}"] + metrics[f"loss_rcnn_reg{i}"]
    metrics["num_pos_rois"] = outputs["stages"][0]["pos"].sum(1).float().mean()
    return total, metrics


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
