"""Faster, Mask and Cascade R-CNN — port of ``mxdetection_tpu.models.detectors.rcnn``.
``rcnn_loss`` and ``rcnn_postprocess`` also serve R-FCN (``rfcn.py``).

Inference: ResNet (with deformable stages for the Cascade R-CNN DCN config)
-> FPN P2-P6 -> RPN -> proposals (per-level top-k, decode, clip, NMS, merged
top-k) -> multilevel RoIAlign 7x7 on P2-P5 -> 2fc bbox head; then
``rcnn_postprocess`` decodes per class (class-agnostic for the cascade) and
runs class-aware NMS. With ``cfg.cascade`` the RoIAlign + head stage runs
``num_stages`` times: each stage's class-agnostic deltas, decoded with that
stage's stds and clipped (``decode_stage_boxes``), are the next stage's
rois; the scores are the mean of the stages' softmaxes and the final boxes
decode the last stage's deltas.

Training (``forward_train`` + ``rcnn_loss``): the same trunk with the
training proposal counts, then ``sample_rois`` picks the second stage's
rois, RoIAlign (differentiable: K1 forward, K3 backward on the card) feeds
the bbox head, and the loss assigns anchors to gt (``assign_max_iou``,
K4's two passes) and subsamples them. With ``cfg.cascade`` each stage after the
first takes the rois the previous stage refined (decoded from its detached
deltas) and labels them by IoU at its threshold (``relabel_rois``, K4's pass
A, no subsampling); the loss weighs stage i by ``stage_loss_weights[i]``. The
random draws of the two samplers come from an injectable source
(``ops/matching.py``). With ``bbox_head.ohem`` each image's stage loss keeps
only its ``ohem_keep`` hardest valid rois (online hard example mining,
R-FCN's recipe).

Mask R-CNN (``cfg.mask_head``): in training the mask branch runs on the
first ``round(num_samples * pos_fraction)`` sampled rois of stage 0, the fg
quota, which ``sample_rois`` fills with the positives first: RoIAlign at
``roi_output_size`` (14, K1 and K3 again) with the positives as the valid
mask, the mask head, and targets cropped from the matched gt's box mask
(``ops/mask_target.py``); ``rcnn_loss`` adds the BCE of each positive's gt
class slice. At inference ``mask_forward`` runs the branch on the final
detections and ``mask_probs`` gives each detection's mask probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import Config

from ...losses.losses import mask_bce_loss, ohem_select, smooth_l1_loss
from ...ops import anchors as anchor_lib
from ...ops import boxes as box_lib
from ...ops import matching
from ...ops import nms as nms_lib
from ...ops.mask_target import mask_targets_for_rois
from ...ops.proposals import generate_proposals
from ...ops.roi_align import multilevel_roi_align
from ...utils.profiling import annotate
from ..backbones.resnet import ResNet
from ..heads.bbox_head import BBoxHead, MaskHead
from ..heads.rpn import RPNHead
from ..necks.fpn import FPN


RCNN_DETECTORS = ("faster_rcnn", "mask_rcnn", "cascade_rcnn")


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


def relabel_rois(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels1: torch.Tensor, gt_valid: torch.Tensor, iou_thr: float) -> tuple:
    """Cascade stage re-assignment, batched over images: rois (B, R, 4),
    roi_valid (B, R), gt (B, G, ...) -> (labels (B, R) int32, matched
    (B, R), pos (B, R)). A roi is positive when its best IoU with a valid gt
    reaches ``iou_thr`` (invalid gt count IoU -1; ties go to the first gt),
    labelled with that gt's 1-based class; other valid rois are background
    (0), invalid rois -1. No subsampling, as the cascade's targets."""
    max_iou, matched = matching.max_iou_rows(rois.float(), gt_boxes.float(), gt_valid)
    pos = roi_valid & (max_iou >= iou_thr)
    labels = torch.where(pos, torch.gather(gt_labels1, 1, matched), 0)
    labels = torch.where(roi_valid, labels, -1).to(torch.int32)
    return labels, matched, pos


def decode_stage_boxes(rois: torch.Tensor, deltas: torch.Tensor, stds,
                       image_hw: torch.Tensor) -> torch.Tensor:
    """Class-agnostic decode + clip for cascade refinement: rois (B, R, 4),
    deltas (B, R, 4), image_hw (B, 2) -> (B, R, 4)."""
    boxes = box_lib.decode_boxes(rois, deltas, stds=stds)
    return box_lib.clip_boxes(boxes, image_hw[:, None, :])


class RCNN(nn.Module):
    """Faster R-CNN (FPN), Mask R-CNN with ``cfg.mask_head``, or Cascade
    R-CNN with ``cfg.cascade``. Parameter names follow the JAX module tree
    (``bbox_head0`` .. ``bbox_head{n-1}``, ``mask_head``), so
    ``utils/convert.py`` maps a flax checkpoint 1:1. Computes in
    ``cfg.backbone.dtype`` whatever the dtype of its parameters."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        if c.detector not in RCNN_DETECTORS:
            raise ValueError(f"RCNN builds {RCNN_DETECTORS}, not {c.detector!r}")
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
        self.num_stages = c.cascade.num_stages if c.cascade else 1
        self.class_agnostic = bool(c.cascade) or c.bbox_head.class_agnostic
        for i in range(self.num_stages):
            self.add_module(f"bbox_head{i}", BBoxHead(
                p * p * c.fpn.out_channels, num_classes=c.bbox_head.num_classes,
                fc_channels=c.bbox_head.fc_channels, class_agnostic=self.class_agnostic))
        self.mask_head = None if c.mask_head is None else MaskHead(
            c.fpn.out_channels, num_classes=c.bbox_head.num_classes,
            num_convs=c.mask_head.num_convs, channels=c.mask_head.channels)

    def bbox_head(self, i: int) -> BBoxHead:
        return getattr(self, f"bbox_head{i}")

    def _stage_stds(self, i: int):
        c = self.cfg
        return c.cascade.stage_bbox_stds[i] if c.cascade else c.bbox_head.bbox_stds

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.backbone, self.fpn, self.rpn):
            m.reset_parameters(gen)
        for i in range(self.num_stages):
            self.bbox_head(i).reset_parameters(gen)
        if self.mask_head is not None:
            self.mask_head.reset_parameters(gen)

    def extract(self, images: torch.Tensor) -> list:
        return self.fpn(self.backbone(images))

    @torch.no_grad()
    def forward_test(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        """images (B, H, W, 3) NHWC, im_info (B, 3) rows (h, w, scale).
        Spans: ``infer.backbone``; ``infer.rpn`` (the FPN, the RPN head, the
        anchors and the proposals); ``infer.roi_heads`` (each stage's
        RoIAlign, head and decode)."""
        c = self.cfg
        b = images.shape[0]
        with annotate("infer.backbone"):
            feats = self.backbone(images.to(self.compute_dtype))
        with annotate("infer.rpn"):
            pyramid = self.fpn(feats)
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

        with annotate("infer.roi_heads"):
            stage_rois, probs_sum, deltas = rois, None, None
            for i in range(self.num_stages):
                roi_feats = batched_roi_align(pyramid, stage_rois, roi_valid, c, c.roi.output_size)
                s = roi_feats.shape[1]
                cls_logits, deltas = self.bbox_head(i)(
                    roi_feats.reshape(b * s, *roi_feats.shape[2:]))
                deltas = deltas.reshape(b, s, -1)
                p = torch.softmax(cls_logits.reshape(b, s, -1), dim=-1)
                probs_sum = p if probs_sum is None else probs_sum + p
                if i + 1 < self.num_stages:
                    stage_rois = decode_stage_boxes(stage_rois, deltas, self._stage_stds(i),
                                                    resized_hw)
        return {
            "pyramid": pyramid,
            "rois": stage_rois, "roi_valid": roi_valid,
            "probs": probs_sum / self.num_stages,
            "deltas": deltas,  # the last stage's
            "final_stds": self._stage_stds(self.num_stages - 1),
            "class_agnostic": self.class_agnostic,
        }

    def forward(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        return self.forward_test(images, im_info)

    @torch.no_grad()
    def mask_forward(self, pyramid: list, det_boxes: torch.Tensor,
                     det_valid: torch.Tensor) -> torch.Tensor:
        """The mask branch on final detections: det_boxes (B, D, 4) in
        resized-image coordinates, det_valid (B, D) -> (B, D, M, M, C) f32
        logits (M = ``mask_size``, C = ``num_classes``)."""
        m = self.cfg.mask_head
        b, d = det_boxes.shape[:2]
        feats = batched_roi_align(pyramid, det_boxes, det_valid, self.cfg, m.roi_output_size)
        logits = self.mask_head(feats.reshape(b * d, *feats.shape[2:]))
        return logits.reshape(b, d, m.mask_size, m.mask_size, -1)

    def forward_train(self, tb: dict, draws: matching.Draws) -> dict:
        """tb: images (B, H, W, 3), im_info (B, 3), gt_boxes (B, G, 4) in
        network coordinates, gt_labels (B, G) 0-based, gt_valid (B, G), and
        for Mask R-CNN box_masks (B, G, M, M) uint8, each gt's mask in its
        box's frame. Returns each stage's outputs and targets, which
        ``rcnn_loss`` reads."""
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

        stage_rois, labels, matched = sampled.rois, sampled.labels, sampled.matched_gt
        pos, valid = sampled.pos_mask, sampled.valid_mask
        stages = []
        for i in range(self.num_stages):
            roi_feats = batched_roi_align(pyramid, stage_rois, valid, c, c.roi.output_size)
            s = roi_feats.shape[1]
            cls_logits, deltas = self.bbox_head(i)(roi_feats.reshape(b * s, *roi_feats.shape[2:]))
            deltas = deltas.reshape(b, s, -1)
            matched_gt = torch.gather(gt_boxes, 1, matched[..., None].expand(b, s, 4))
            stages.append({
                "cls_logits": cls_logits.reshape(b, s, -1), "deltas": deltas, "labels": labels,
                "reg_targets": box_lib.encode_boxes(stage_rois, matched_gt,
                                                    stds=self._stage_stds(i)),
                "pos": pos, "valid": valid, "rois": stage_rois,
            })
            if i + 1 < self.num_stages:  # refine from detached deltas, then relabel
                stage_rois = decode_stage_boxes(stage_rois, deltas.detach(),
                                                self._stage_stds(i), resized_hw)
                labels, matched, pos = relabel_rois(stage_rois, valid, gt_boxes, gt_labels1,
                                                    gt_valid, c.cascade.stage_iou_thrs[i + 1])
        out = {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "stages": stages, "pad_hw": pad_hw}
        if self.mask_head is not None:
            # The fg quota's prefix holds every positive (sample_rois puts the
            # fg band first): the fg-only mask branch at a static shape.
            m = c.mask_head
            mp = int(round(h.num_samples * h.pos_fraction))
            mask_rois = stages[0]["rois"][:, :mp]
            feats = batched_roi_align(pyramid, mask_rois, stages[0]["pos"][:, :mp], c,
                                      m.roi_output_size)
            logits = self.mask_head(feats.reshape(b * mp, *feats.shape[2:]))
            out["mask_logits"] = logits.reshape(b, mp, m.mask_size, m.mask_size, -1)
            out["mask_targets"] = mask_targets_for_rois(
                tb["box_masks"], gt_boxes, mask_rois, sampled.matched_gt[:, :mp],
                out_size=m.mask_size)
        return out


def rcnn_loss(outputs: dict, tb: dict, draws: matching.Draws, cfg: Config) -> tuple:
    """RPN + stage losses of ``forward_train``'s outputs -> (total, metrics).

    The RPN assigns every anchor inside the resized image to gt (low-quality
    force on), subsamples ``rpn.batch_size`` of them, and takes BCE on the
    objectness and smooth-L1 (beta 1/9) on the positives' deltas; each
    second stage takes softmax CE over its rois and smooth-L1 on the
    positives' class-specific (cascade, R-FCN: class-agnostic) deltas, and
    adds to the total weighted by ``cascade.stage_loss_weights`` (1 without
    a cascade); Mask R-CNN adds ``mask_loss`` as ``loss_mask``. With
    ``bbox_head.ohem`` (R-FCN) a stage's two sums run over each image's
    ``ohem_keep`` hardest valid rois by their cls + reg loss (``keep``, and
    ``keep & pos`` for the reg term), divided by ``max(sum(keep), 1)``; the
    accuracy stays over every valid roi. Everything is f32, as the JAX loss.
    """
    c = cfg
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
        w = c.cascade.stage_loss_weights[i] if c.cascade else 1.0
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
        if c.bbox_head.ohem:  # the hardest ohem_keep valid rois by cls + reg loss
            keep = ohem_select(nll + l1, valid, c.bbox_head.ohem_keep)
            n_keep = keep.sum(-1).clamp(min=1).float()
            cls_loss = torch.where(keep, nll, 0.0).sum(-1) / n_keep
            reg_loss = torch.where(keep & pos_i, l1, 0.0).sum(-1) / n_keep
        else:
            cls_loss, reg_loss = nll.sum(-1) / norm, l1.sum(-1) / norm
        metrics[f"loss_rcnn_cls{i}"] = cls_loss.mean()
        metrics[f"loss_rcnn_reg{i}"] = reg_loss.mean() * c.bbox_head.loss_bbox_weight
        metrics[f"rcnn_acc{i}"] = acc.mean()
        total = total + w * (metrics[f"loss_rcnn_cls{i}"] + metrics[f"loss_rcnn_reg{i}"])
    if "mask_logits" in outputs:
        metrics["loss_mask"] = mask_loss(outputs, c)
        total = total + metrics["loss_mask"]
    metrics["num_pos_rois"] = outputs["stages"][0]["pos"].sum(1).float().mean()
    return total, metrics


def mask_loss(outputs: dict, cfg: Config) -> torch.Tensor:
    """``rcnn_loss``'s mask term: the BCE of each positive's logits of its
    gt class (the branch ran on the fg prefix of stage 0's rois), averaged
    over the images, times ``mask_head.loss_weight``."""
    logits = outputs["mask_logits"]
    b, mp, ms = logits.shape[:3]
    st = outputs["stages"][0]
    cls_idx = (st["labels"][:, :mp].long() - 1).clamp(0, cfg.bbox_head.num_classes - 1)
    sel = torch.gather(logits, -1, cls_idx[..., None, None, None].expand(b, mp, ms, ms, 1))
    loss = mask_bce_loss(sel[..., 0], outputs["mask_targets"], st["pos"][:, :mp])
    return loss.mean() * cfg.mask_head.loss_weight


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


@torch.no_grad()
def mask_probs(model: RCNN, outputs: dict, dets: dict, im_info: torch.Tensor) -> torch.Tensor:
    """Each detection's mask probabilities, as the JAX evaluator forms them:
    ``dets`` of ``rcnn_postprocess`` (boxes in original-image coordinates,
    0-based labels) scaled back into the resized image by ``im_info[:, 2]``,
    ``mask_forward`` on ``outputs["pyramid"]`` of ``forward_test``, each
    detection's label slice, sigmoid -> (B, D, M, M) f32."""
    boxes = dets["boxes"] * im_info[:, 2][:, None, None]
    logits = model.mask_forward(outputs["pyramid"], boxes, dets["valid"])
    b, d, ms = logits.shape[:3]
    cls_idx = dets["labels"].long().clamp(0, logits.shape[-1] - 1)
    sel = torch.gather(logits, -1, cls_idx[..., None, None, None].expand(b, d, ms, ms, 1))
    return torch.sigmoid(sel[..., 0])
