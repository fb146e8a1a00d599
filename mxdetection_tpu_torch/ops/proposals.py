"""Proposal generation: RPN outputs -> fixed-size roi set — port of
``mxdetection_tpu.ops.proposals``.

Per-level top-k -> decode -> clip -> NMS(level) -> merged top-k, batched
over images with no per-image loop: the per-level candidate sets of every
image are padded to one common size and go through ONE batched NMS call
(one kernel launch on the card for all B x L problems). Padding rows carry
score -inf and valid=False, so they never survive and never displace a real
candidate; the outputs equal the JAX per-image ``vmap``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import boxes as box_lib
from . import nms as nms_lib


@torch.no_grad()
def generate_proposals(
    cls_logits: Sequence[torch.Tensor],   # per level (B, H, W, A)
    bbox_deltas: Sequence[torch.Tensor],  # per level (B, H, W, A*4)
    anchors: Sequence[torch.Tensor],      # per level (H*W*A, 4)
    image_hw: torch.Tensor,               # (B, 2) valid (h, w) after resize
    *,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thr: float,
    min_box_size: float = 0.0,
    bbox_stds: tuple = (1.0, 1.0, 1.0, 1.0),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (rois (B, post_nms_top_n, 4), scores (B, post), valid (B, post))."""
    b = image_hw.shape[0]
    ks = [min(pre_nms_top_n, cl[0].numel()) for cl in cls_logits]
    n = max(ks)
    lv_boxes, lv_scores, lv_ok = [], [], []
    for cl, bd, an, k in zip(cls_logits, bbox_deltas, anchors, ks):
        scores = cl.reshape(b, -1).float()
        deltas = bd.reshape(b, -1, 4).float()
        top_scores, idx = nms_lib.topk_stable(scores, k)
        d = torch.gather(deltas, 1, idx[..., None].expand(b, k, 4))
        bx = box_lib.decode_boxes(an[idx], d, stds=bbox_stds)
        bx = box_lib.clip_boxes(bx, image_hw[:, None, :])
        ok = box_lib.valid_box_mask(bx, min_box_size)
        if k < n:  # pad this level to the common candidate count
            pad = n - k
            bx = torch.cat([bx, bx.new_zeros(b, pad, 4)], 1)
            top_scores = torch.cat([top_scores, top_scores.new_full((b, pad), -float("inf"))], 1)
            ok = torch.cat([ok, ok.new_zeros(b, pad)], 1)
        lv_boxes.append(bx)
        lv_scores.append(top_scores)
        lv_ok.append(ok)

    # per-level NMS (family convention) for all (image, level) problems at once
    keep_n = min(post_nms_top_n, n)
    nb, ns, nv = nms_lib.nms(torch.stack(lv_boxes, 1), torch.stack(lv_scores, 1),
                             nms_thr, keep_n, valid=torch.stack(lv_ok, 1))
    all_boxes = nb.reshape(b, -1, 4)
    all_scores = torch.where(nv, ns, torch.full_like(ns, -float("inf"))).reshape(b, -1)
    k = min(post_nms_top_n, sum(min(post_nms_top_n, kl) for kl in ks))
    top_scores, idx = nms_lib.topk_stable(all_scores, k)
    valid = top_scores > -float("inf")
    rois = torch.gather(all_boxes, 1, idx[..., None].expand(b, k, 4))
    rois = torch.where(valid[..., None], rois, torch.zeros_like(rois))
    return rois, torch.where(valid, top_scores, torch.zeros_like(top_scores)), valid
