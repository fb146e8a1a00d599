"""RetinaNet — port of ``mxdetection_tpu.models.detectors.retinanet``.

ResNet -> FPN P3-P7 (conv P6/P7) -> the shared cls/reg subnets. Training
(``retinanet_loss``): every anchor of every level is assigned to the gt by
``assign_max_iou`` (positive at IoU >= 0.5, negative below 0.4, the
low-quality force on: K4's two passes on the card), then the sigmoid focal
loss over every (anchor, class) and smooth-L1 (beta 0.11) on the
positives, each normalised by the image's positives. Nothing is sampled, so
the loss draws nothing. Inference (``retinanet_postprocess``): per level the
top (anchor, class) pairs, decoded, then clipped, the merged top-k cap and
class-aware NMS (K2 on the card). Everything is batched over the images.

Tie order. Every top-k here is ``topk_stable``: of equal values the lower
index first, as ``lax.top_k`` orders them on both devices. A random-weight
net scores many pairs alike, so the order decides which survive, and the
frozen fixture was made through the two-stage ``topk_pairs``
(``test.exact_topk=False`` by default).
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import Config
from ...losses.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops import anchors as anchor_lib
from ...ops import boxes as box_lib
from ...ops import matching
from ...ops import nms as nms_lib
from ..backbones.resnet import ResNet
from ..heads.retina import RetinaHead
from ..necks.fpn import FPN


class RetinaNet(nn.Module):
    """``backbone``, ``fpn`` and ``head``, named as the flax module tree, so
    ``utils/convert.py`` maps a flax checkpoint 1:1. Computes in
    ``cfg.backbone.dtype`` whatever the dtype of its parameters.

    ``forward_test`` and ``forward_train`` take the R-CNN family's
    arguments, so that callers drive every detector alike; both are
    ``forward`` of the images."""

    def __init__(self, cfg: Config):
        super().__init__()
        c, h = cfg, cfg.retina_head
        self.cfg = cfg
        self.compute_dtype = getattr(torch, c.backbone.dtype)
        self.backbone = ResNet(depth=c.backbone.depth, norm_kind=c.backbone.norm,
                               frozen_stages=c.backbone.frozen_stages,
                               dcn_stages=c.backbone.dcn_stages, remat=c.backbone.remat)
        self.fpn = FPN(out_channels=c.fpn.out_channels, min_level=c.fpn.min_level,
                       max_level=c.fpn.max_level, extra_convs=c.fpn.extra_convs)
        self.head = RetinaHead(num_classes=h.num_classes,
                               num_anchors=len(h.ratios) * h.scales_per_octave,
                               stacked_convs=h.stacked_convs, channels=h.channels,
                               prior_prob=h.prior_prob, in_channels=c.fpn.out_channels)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.backbone, self.fpn, self.head):
            m.reset_parameters(gen)

    def forward(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) NHWC -> {"cls": [(B, H_l, W_l, A*C)], "reg":
        [(B, H_l, W_l, A*4)], "pad_hw": (H, W)}."""
        cls_logits, bbox_deltas = self.head(self.fpn(self.backbone(
            images.to(self.compute_dtype))))
        return {"cls": cls_logits, "reg": bbox_deltas, "pad_hw": tuple(images.shape[1:3])}

    @torch.no_grad()
    def forward_test(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        return self(images)

    def forward_train(self, tb: dict, draws: matching.Draws) -> dict:
        return self(tb["images"])


def level_anchors(cfg: Config, image_hw: tuple[int, int], device=None) -> list:
    """Each level's anchors for the padded image shape: scales
    ``octave_base_scale * 2^(i / scales_per_octave)``, [(H_l*W_l*A, 4)]."""
    h = cfg.retina_head
    strides = [2 ** lv for lv in range(cfg.fpn.min_level, cfg.fpn.max_level + 1)]
    gen = anchor_lib.AnchorGenerator(
        strides=strides,
        scales=tuple(h.octave_base_scale * 2 ** (i / h.scales_per_octave)
                     for i in range(h.scales_per_octave)),
        ratios=h.ratios)
    return gen.per_level([(-(-image_hw[0] // s), -(-image_hw[1] // s)) for s in strides],
                         device=device)


def make_anchors(cfg: Config, image_hw: tuple[int, int], device=None) -> torch.Tensor:
    """All anchors for the padded image shape, concatenated over the levels (A_tot, 4)."""
    return torch.cat(level_anchors(cfg, image_hw, device), 0)


def _flatten_levels(per_level: list, last_dim: int) -> torch.Tensor:
    """[(B, H, W, A*D)] -> (B, sum HWA, D), in the anchors' row-major order."""
    b = per_level[0].shape[0]
    return torch.cat([p.reshape(b, -1, last_dim) for p in per_level], 1)


def retinanet_loss(outputs: dict, tb: dict, draws: matching.Draws, cfg: Config) -> tuple:
    """Focal + smooth-L1 loss of ``forward_train``'s outputs -> (total,
    metrics), batched over the images, in f32. tb: gt_boxes (B, G, 4),
    gt_labels (B, G) 0-based, gt_valid (B, G). ``draws`` is not read."""
    h = cfg.retina_head
    num_classes = h.num_classes
    cls = _flatten_levels(outputs["cls"], num_classes).float()
    reg = _flatten_levels(outputs["reg"], 4).float()
    b, n = cls.shape[:2]
    anchors = make_anchors(cfg, outputs["pad_hw"], device=cls.device)
    gt_boxes, gt_valid = tb["gt_boxes"].float(), tb["gt_valid"]

    res = matching.assign_max_iou(anchors.expand(b, n, 4), gt_boxes, gt_valid,
                                  pos_iou_thr=h.pos_iou_thr, neg_iou_thr=h.neg_iou_thr,
                                  match_low_quality=True)
    matched = res.matched_gt.long()
    pos, neg = res.labels == 1, res.labels == 0
    num_pos = pos.sum(-1).clamp(min=1).float()

    # one-hot targets; ignored anchors contribute nothing
    tgt_cls = torch.where(pos, torch.gather(tb["gt_labels"].long(), 1, matched), -1)
    onehot = (tgt_cls[..., None] == torch.arange(num_classes, device=cls.device)).float()
    fl = sigmoid_focal_loss(cls, onehot, alpha=h.focal_alpha, gamma=h.focal_gamma)
    cls_loss = torch.where((pos | neg)[..., None], fl, 0.0).sum((1, 2)) / num_pos

    tgt_reg = box_lib.encode_boxes(
        anchors[None], torch.gather(gt_boxes, 1, matched[..., None].expand(b, n, 4)),
        stds=h.bbox_stds)
    l1 = smooth_l1_loss(reg, tgt_reg, beta=h.smooth_l1_beta)
    reg_loss = torch.where(pos[..., None], l1, 0.0).sum((1, 2)) / num_pos

    metrics = {"loss_cls": cls_loss.mean(), "loss_reg": reg_loss.mean(),
               "num_pos": num_pos.mean()}
    return metrics["loss_cls"] + metrics["loss_reg"], metrics


def topk_pairs(logits: torch.Tensor, k: int, num_classes: int) -> tuple:
    """Top-k (anchor, class) pairs of logits (B, A, C) in two stages, as the
    JAX function: the top ``min(k, A)`` anchors by their best class, then
    the top k of those anchors' class rows in f32. Exact but for the order
    of ties at the anchor cut. -> (scores, anchor index, class index), each
    (B, k)."""
    ka = min(k, logits.shape[-2])
    _, a1 = nms_lib.topk_stable(logits.amax(-1), ka)
    rows = torch.gather(logits, 1, a1[..., None].expand(*a1.shape, num_classes)).float()
    s2, f2 = nms_lib.topk_stable(rows.reshape(rows.shape[0], -1), min(k, ka * num_classes))
    return s2, torch.gather(a1, 1, f2 // num_classes), f2 % num_classes


def topk_pairs_exact(logits: torch.Tensor, k: int, num_classes: int) -> tuple:
    """Exact (anchor, class) top-k over all A*C pairs in f32 (``test.exact_topk``)."""
    flat = logits.reshape(logits.shape[0], -1).float()
    s, f = nms_lib.topk_stable(flat, min(k, flat.shape[-1]))
    return s, f // num_classes, f % num_classes


@torch.no_grad()
def retinanet_postprocess(outputs: dict, cfg: Config, image_hw: tuple[int, int],
                          im_info: torch.Tensor) -> dict:
    """Per-level top pairs, decode, clip, the merged top-k cap and
    class-aware NMS, batched over images. im_info (B, 3) rows (orig_h,
    orig_w, scale). Returns fixed (B, max_per_image) detections in original
    image coordinates, labels 0-based."""
    h, t = cfg.retina_head, cfg.test
    num_classes = h.num_classes
    select_pairs = topk_pairs_exact if t.exact_topk else topk_pairs
    b = im_info.shape[0]
    cand_boxes, cand_scores, cand_labels = [], [], []
    for cls, reg, anchors in zip(outputs["cls"], outputs["reg"],
                                 level_anchors(cfg, image_hw, device=im_info.device)):
        na = anchors.shape[0]
        k = min(t.pre_nms_per_class, na * num_classes)
        top_logits, a_idx, c_idx = select_pairs(cls.reshape(b, na, num_classes), k,
                                                num_classes)
        deltas = torch.gather(reg.reshape(b, na, 4), 1, a_idx[..., None].expand(b, k, 4))
        cand_boxes.append(box_lib.decode_boxes(anchors[a_idx], deltas.float(),
                                               stds=h.bbox_stds))
        cand_scores.append(torch.sigmoid(top_logits))
        cand_labels.append(c_idx)
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    labels = torch.cat(cand_labels, 1)

    boxes = box_lib.clip_boxes(boxes, (im_info[:, :2] * im_info[:, 2:3])[:, None, :])
    k = min(t.pre_nms_per_class, scores.shape[1])
    scores, idx = nms_lib.topk_stable(scores, k)
    boxes = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    labels = torch.gather(labels, 1, idx)

    ob, os_, ol, ov = nms_lib.class_aware_nms_from_cfg(t, boxes, scores, labels)
    ob = box_lib.clip_boxes(ob / im_info[:, 2][:, None, None], im_info[:, None, :2])
    return {"boxes": ob, "scores": os_, "labels": ol, "valid": ov}
