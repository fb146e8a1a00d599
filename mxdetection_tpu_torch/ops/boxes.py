"""Box geometry ops: IoU, encode/decode, clipping — port of ``mxdetection_tpu.ops.boxes``.

All boxes are ``(..., 4)`` float tensors in ``(x1, y1, x2, y2)`` corner
layout. Invalid/padding boxes are conventionally all-zero rows; IoU against
them is 0 so they never match. The arithmetic follows the JAX functions
operation for operation, so that IoU decisions at a threshold agree.
"""

from __future__ import annotations

import torch

# Box widths are (x2 - x1 + LEGACY_OFFSET); the modern COCO convention is 0.
LEGACY_OFFSET = 0.0


def box_area(boxes: torch.Tensor, offset: float = LEGACY_OFFSET) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes. Degenerate boxes clamp to 0."""
    w = (boxes[..., 2] - boxes[..., 0] + offset).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1] + offset).clamp(min=0.0)
    return w * h


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 offset: float = LEGACY_OFFSET) -> torch.Tensor:
    """IoU between (..., N, 4) and (..., K, 4) boxes -> (..., N, K).

    Zero-area (padding) boxes produce IoU exactly 0 rather than NaN.
    """
    area1 = box_area(boxes1, offset)
    area2 = box_area(boxes2, offset)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + offset).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def pairwise_iof(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 offset: float = LEGACY_OFFSET) -> torch.Tensor:
    """Intersection over the area of ``boxes1``: (..., N, 4) x (..., K, 4) -> (..., N, K)."""
    area1 = box_area(boxes1, offset)[..., :, None]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + offset).clamp(min=0.0)
    iof = wh[..., 0] * wh[..., 1] / area1.clamp(min=1e-12)
    return torch.where(area1 > 0, iof, torch.zeros_like(iof))


def encode_boxes(
    rois: torch.Tensor,
    gt: torch.Tensor,
    means: tuple = (0.0, 0.0, 0.0, 0.0),
    stds: tuple = (1.0, 1.0, 1.0, 1.0),
    offset: float = LEGACY_OFFSET,
) -> torch.Tensor:
    """xyxy (rois, matched gt) -> normalised (dx, dy, dw, dh) deltas, the
    inverse of ``decode_boxes``. Shapes broadcast; the last dim is 4.
    Widths and heights are clamped at 1e-6, as the JAX function does."""
    ex_w = rois[..., 2] - rois[..., 0] + offset
    ex_h = rois[..., 3] - rois[..., 1] + offset
    ex_cx = rois[..., 0] + 0.5 * ex_w
    ex_cy = rois[..., 1] + 0.5 * ex_h

    gt_w = gt[..., 2] - gt[..., 0] + offset
    gt_h = gt[..., 3] - gt[..., 1] + offset
    gt_cx = gt[..., 0] + 0.5 * gt_w
    gt_cy = gt[..., 1] + 0.5 * gt_h

    ex_w = ex_w.clamp(min=1e-6)
    ex_h = ex_h.clamp(min=1e-6)
    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w.clamp(min=1e-6) / ex_w)
    dh = torch.log(gt_h.clamp(min=1e-6) / ex_h)

    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means_t) / stds_t


def decode_boxes(
    rois: torch.Tensor,
    deltas: torch.Tensor,
    means: tuple = (0.0, 0.0, 0.0, 0.0),
    stds: tuple = (1.0, 1.0, 1.0, 1.0),
    wh_clip: float = 4.135166556742356,  # log(1000/16): reference-family clamp
    offset: float = LEGACY_OFFSET,
) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to xyxy rois -> predicted xyxy boxes.

    ``deltas`` may have a trailing dim that is a multiple of 4
    (class-specific regression); rois broadcast against its leading dims.
    """
    orig_shape = deltas.shape
    deltas = deltas.reshape(*orig_shape[:-1], -1, 4)
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    deltas = deltas * stds_t + means_t

    w = rois[..., 2] - rois[..., 0] + offset
    h = rois[..., 3] - rois[..., 1] + offset
    cx = rois[..., 0] + 0.5 * w
    cy = rois[..., 1] + 0.5 * h

    dx, dy, dw, dh = deltas.unbind(-1)
    dw = dw.clamp(max=wh_clip)
    dh = dh.clamp(max=wh_clip)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w + 0.5 * offset,
            pred_cy - 0.5 * pred_h + 0.5 * offset,
            pred_cx + 0.5 * pred_w - 0.5 * offset,
            pred_cy + 0.5 * pred_h - 0.5 * offset,
        ],
        dim=-1,
    )
    return out.reshape(orig_shape)


def clip_boxes(boxes: torch.Tensor, im_hw: torch.Tensor,
               offset: float = LEGACY_OFFSET) -> torch.Tensor:
    """Clip xyxy boxes to [0, W-offset] x [0, H-offset].

    ``im_hw`` is (..., 2) (height, width), broadcastable against the boxes'
    leading dims.
    """
    h = im_hw[..., 0] - offset
    w = im_hw[..., 1] - offset
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def flip_boxes(boxes: torch.Tensor, im_w: torch.Tensor,
               offset: float = LEGACY_OFFSET) -> torch.Tensor:
    """Horizontal flip of xyxy boxes within image width ``im_w``."""
    x1 = im_w - offset - boxes[..., 2]
    x2 = im_w - offset - boxes[..., 0]
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def valid_box_mask(boxes: torch.Tensor, min_size: float = 0.0) -> torch.Tensor:
    """True for boxes with positive extent above ``min_size`` on both axes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > min_size) & (h > min_size)
