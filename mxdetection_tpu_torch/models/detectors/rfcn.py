"""R-FCN — port of ``mxdetection_tpu.models.detectors.rfcn``.

ResNet with a dilated C5 (stride 16). C4 feeds a single-level RPN (a 512-wide
head on the 1024-wide C4, 12 anchors a cell at stride 16) and the proposals
(per-level top-k of one level, decode, clip, NMS: K2 on the card, one
problem an image). C5 feeds the 1x1 ``conv_new`` (+ ReLU) and two 1x1 convs
emitting k^2*(C+1) class and k^2*4 box position-sensitive maps. Each roi's
PSRoIPool (``ops/psroi.py``, plain PyTorch: the JAX package pools with an
XLA gather) is averaged over its k x k bins into class logits and
class-agnostic deltas: there is no per-roi fc head. With
``rfcn_head.deform_pool`` a zero-initialised 1x1 ``rfcn_offset`` emits
k^2*2 offset maps; a plain pool reads each bin's raw offsets and the class
and box pools shift their bins by them, scaled by ``trans_std * (roi_h,
roi_w)``.

The outputs have the R-CNN family's schema, so ``rcnn_loss`` (with OHEM
under ``bbox_head.ohem``) and ``rcnn_postprocess`` serve R-FCN, and its
``forward_test(images, im_info)`` and ``forward_train(tb, draws)`` take
``RCNN``'s arguments. Training samples ``bbox_head.num_samples`` rois with
``sample_rois`` (K4's pass A on the card) and assigns the RPN's anchors in
``rcnn_loss`` (K4's two passes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import Config
from ...ops import boxes as box_lib
from ...ops import matching
from ...ops.proposals import generate_proposals
from ...ops.psroi import psroi_pool
from ..backbones.resnet import ResNet
from ..heads.rpn import RPNHead
from ..layers import conv, init_layer_
from .rcnn import rpn_anchor_cfg, rpn_level_anchors

RPN_CHANNELS = 512
C4_CHANNELS, C5_CHANNELS = 1024, 2048
STRIDE = 16  # C4 and the dilated C5


class RFCN(nn.Module):
    """``backbone``, ``rpn``, ``conv_new``, ``rfcn_cls``, ``rfcn_bbox`` and
    (with ``deform_pool``) ``rfcn_offset``, named as the flax module tree.
    Computes in ``cfg.backbone.dtype`` whatever the dtype of its parameters."""

    def __init__(self, cfg: Config):
        super().__init__()
        c, r = cfg, cfg.rfcn_head
        self.cfg = cfg
        self.compute_dtype = getattr(torch, c.backbone.dtype)
        self.backbone = ResNet(depth=c.backbone.depth, norm_kind=c.backbone.norm,
                               frozen_stages=c.backbone.frozen_stages,
                               dcn_stages=c.backbone.dcn_stages,
                               dilated_c5=c.backbone.dilated_c5, remat=c.backbone.remat)
        self.rpn = RPNHead(num_anchors=rpn_anchor_cfg(c).num_base_anchors,
                           channels=RPN_CHANNELS, in_channels=C4_CHANNELS)
        k, nc1 = r.ps_grid, c.bbox_head.num_classes + 1
        self.conv_new = conv(C5_CHANNELS, r.reduce_channels, 1, use_bias=True)
        self.rfcn_cls = conv(r.reduce_channels, k * k * nc1, 1, use_bias=True)
        self.rfcn_bbox = conv(r.reduce_channels, k * k * 4, 1, use_bias=True)
        self.rfcn_offset = (conv(r.reduce_channels, k * k * 2, 1, use_bias=True)
                            if r.deform_pool else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """normal(0.01) for the three maps' convs; ``rfcn_offset`` zero, so
        the pools start on the plain grid (the DCN recipe)."""
        self.backbone.reset_parameters(gen)
        self.rpn.reset_parameters(gen)
        for m in (self.conv_new, self.rfcn_cls, self.rfcn_bbox):
            init_layer_(m, "normal", gen, std=0.01)
        if self.rfcn_offset is not None:
            with torch.no_grad():
                self.rfcn_offset.weight.zero_()
                self.rfcn_offset.bias.zero_()

    def _ps_maps(self, c5: torch.Tensor) -> tuple:
        """C5 (B, H, W, 2048) -> the class, box and offset maps, NHWC."""
        feat = F.relu(self.conv_new(c5.permute(0, 3, 1, 2)))
        maps = [m(feat).permute(0, 2, 3, 1) for m in (self.rfcn_cls, self.rfcn_bbox)]
        off = None if self.rfcn_offset is None else self.rfcn_offset(feat).permute(0, 2, 3, 1)
        return maps[0], maps[1], off

    def _pool_scores(self, cls_map, reg_map, off_map, rois, roi_valid) -> tuple:
        """rois (B, S, 4) in resized-image coordinates -> ((B, S, C+1)
        logits, (B, S, 4) deltas), f32: each pooled bin map averaged over
        its bins."""
        r = self.cfg.rfcn_head
        k = r.ps_grid
        offs = None
        if off_map is not None:
            offs = psroi_pool(off_map, rois, STRIDE, output_size=k, roi_valid=roi_valid).float()
        cls_bins, reg_bins = (psroi_pool(m, rois, STRIDE, output_size=k, offsets=offs,
                                         trans_std=r.trans_std, roi_valid=roi_valid)
                              for m in (cls_map, reg_map))
        return cls_bins.float().mean((2, 3)), reg_bins.float().mean((2, 3))

    def _rpn_and_proposals(self, images: torch.Tensor, im_info: torch.Tensor, pre_n: int,
                           post_n: int) -> tuple:
        c = self.cfg
        _, _, c4, c5 = self.backbone(images.to(self.compute_dtype))
        rpn_cls, rpn_reg = self.rpn([c4])
        pad_hw = (images.shape[1], images.shape[2])
        anchors = rpn_level_anchors(c, pad_hw, device=images.device)
        resized_hw = im_info[:, :2] * im_info[:, 2:3]
        rois, _, roi_valid = generate_proposals(
            rpn_cls, rpn_reg, anchors, resized_hw, pre_nms_top_n=pre_n, post_nms_top_n=post_n,
            nms_thr=c.rpn.nms_thr, min_box_size=c.rpn.min_box_size, bbox_stds=c.rpn.bbox_stds)
        return c5, rpn_cls, rpn_reg, rois, roi_valid, pad_hw

    @torch.no_grad()
    def forward_test(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        """images (B, H, W, 3) NHWC, im_info (B, 3) rows (h, w, scale)."""
        c = self.cfg
        c5, _, _, rois, roi_valid, _ = self._rpn_and_proposals(
            images, im_info, c.rpn.pre_nms_top_n_test, c.rpn.post_nms_top_n_test)
        cls_logits, deltas = self._pool_scores(*self._ps_maps(c5), rois, roi_valid)
        return {
            "rois": rois, "roi_valid": roi_valid,
            "probs": torch.softmax(cls_logits, dim=-1),
            "deltas": deltas,
            "final_stds": c.bbox_head.bbox_stds,
            "class_agnostic": True,  # k^2*4 box maps
        }

    def forward_train(self, tb: dict, draws: matching.Draws) -> dict:
        """tb as ``RCNN.forward_train``'s (no box masks). Returns one stage
        of outputs and targets, which ``rcnn_loss`` reads."""
        c, h = self.cfg, self.cfg.bbox_head
        c5, rpn_cls, rpn_reg, rois, roi_valid, pad_hw = self._rpn_and_proposals(
            tb["images"], tb["im_info"], c.rpn.pre_nms_top_n_train, c.rpn.post_nms_top_n_train)
        b = rois.shape[0]
        gt_boxes, gt_valid = tb["gt_boxes"].float(), tb["gt_valid"]
        gt_labels1 = torch.where(gt_valid, tb["gt_labels"] + 1, 0)
        sampled = matching.sample_rois(
            rois, roi_valid, gt_boxes, gt_labels1, gt_valid,
            matching.random_rank(draws, "sample_rois", b, gt_boxes.shape[1] + rois.shape[1]),
            num_samples=h.num_samples, pos_fraction=h.pos_fraction,
            pos_iou_thr=h.pos_iou_thr, neg_iou_thr_hi=h.neg_iou_thr_hi,
            neg_iou_thr_lo=h.neg_iou_thr_lo)
        cls_logits, deltas = self._pool_scores(*self._ps_maps(c5), sampled.rois,
                                               sampled.valid_mask)
        s = sampled.rois.shape[1]
        matched_gt = torch.gather(gt_boxes, 1, sampled.matched_gt[..., None].expand(b, s, 4))
        return {
            "rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "pad_hw": pad_hw,
            "stages": [{
                "cls_logits": cls_logits, "deltas": deltas, "labels": sampled.labels,
                "reg_targets": box_lib.encode_boxes(sampled.rois, matched_gt,
                                                    stds=h.bbox_stds),
                "pos": sampled.pos_mask, "valid": sampled.valid_mask, "rois": sampled.rois,
            }],
        }
