"""Mask targets: gt instance masks cropped to the rois' grids — port of
``mxdetection_tpu.ops.mask_target``.

Each gt instance comes as an M x M mask of its own box (rasterized once at
load time, and mirrored there for a flipped image), and a roi's target is a
bilinear crop of that small mask at the roi's ``out_size`` x ``out_size``
pixel centres. Batched over (images, rois) with gathers; no loop over rois.
"""

from __future__ import annotations

import torch


def _axis_weights(c: torch.Tensor, m: int) -> tuple:
    """The JAX ``axis_weights``: coordinates in (-1, m) are clamped to
    [0, m - 1] and weigh their two taps, others weigh 0."""
    inside = (c > -1.0) & (c < m)
    cc = c.clamp(0.0, m - 1.0)
    lo = torch.floor(cc)
    hi = torch.clamp(lo + 1.0, max=m - 1.0)
    w_hi = cc - lo
    zero = torch.zeros_like(w_hi)
    return lo.long(), hi.long(), torch.where(inside, 1.0 - w_hi, zero), torch.where(inside, w_hi,
                                                                                    zero)


def crop_box_masks(box_masks: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """Sample each roi's (out_size, out_size) crop of its box mask.

    box_masks (..., M, M) in [0, 1], each covering exactly its ``gt_boxes``
    (..., 4); rois (..., 4) xyxy in image coordinates -> (..., S, S) f32.
    Pixels of the roi outside the gt box get 0. The operations and their
    order are the JAX function's, with divisions by tensors (CUDA turns a
    division by a Python number into a product with its reciprocal).
    """
    m = box_masks.shape[-1]
    dev = rois.device
    masks = box_masks.float().reshape(*box_masks.shape[:-2], m * m)
    gt_boxes, rois = gt_boxes.float(), rois.float()
    gw = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=1e-3)[..., None]
    gh = (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=1e-3)[..., None]
    ii = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / torch.tensor(
        float(out_size), device=dev)
    ys = rois[..., 1:2] + ii * (rois[..., 3:4] - rois[..., 1:2])   # (..., S)
    xs = rois[..., 0:1] + ii * (rois[..., 2:3] - rois[..., 0:1])
    y0, y1, wy0, wy1 = _axis_weights((ys - gt_boxes[..., 1:2]) / gh * m - 0.5, m)
    x0, x1, wx0, wx1 = _axis_weights((xs - gt_boxes[..., 0:1]) / gw * m - 0.5, m)

    def tap(yi, xi):  # box_mask[yi][:, xi]: (..., S, S)
        idx = yi[..., :, None] * m + xi[..., None, :]
        return torch.gather(masks, -1, idx.flatten(-2)).view(idx.shape)

    return (tap(y0, x0) * (wy0[..., :, None] * wx0[..., None, :])
            + tap(y0, x1) * (wy0[..., :, None] * wx1[..., None, :])
            + tap(y1, x0) * (wy1[..., :, None] * wx0[..., None, :])
            + tap(y1, x1) * (wy1[..., :, None] * wx1[..., None, :]))


def mask_targets_for_rois(box_masks: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                          matched_gt: torch.Tensor, out_size: int = 28,
                          binarize: float = 0.5) -> torch.Tensor:
    """box_masks (B, G, M, M) uint8 or float, gt_boxes (B, G, 4), rois
    (B, R, 4), matched_gt (B, R) gt index of each roi -> (B, R, S, S) f32
    targets in {0, 1}: the crop of the matched gt's mask, ``>= binarize``."""
    b, r = matched_gt.shape
    m = box_masks.shape[-1]
    idx = matched_gt.long()
    sel_masks = torch.gather(box_masks, 1, idx[..., None, None].expand(b, r, m, m))
    sel_boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(b, r, 4))
    out = crop_box_masks(sel_masks, sel_boxes, rois, out_size)
    return (out >= binarize).float()
