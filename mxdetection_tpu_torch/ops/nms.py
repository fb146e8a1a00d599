"""Greedy NMS with fixed shapes — port of ``mxdetection_tpu.ops.nms``.

Every function here is batched over leading dimensions: a call with boxes
(..., N, 4) solves one independent NMS problem per leading index, and on the
card one kernel launch serves them all (per (image, level) for the RPN, per
image for the class-aware test NMS).

``nms_mask_sorted`` is the dispatch point: CPU tensors take
``nms_mask_sorted_plain`` (N vectorised suppression steps over the IoU
matrix, the ``lax.fori_loop`` of the JAX reference), CUDA tensors take the
bitmask kernel of ``ops/cuda/nms.py``; any other device raises. Both give the
exact greedy keep mask over the whole sorted set (no early exit), so a
top-``max_out`` selection of it equals the JAX one.

Sorting and top-k use ``torch.sort(..., stable=True)``: ties are broken by
lowest index first, as ``jnp.argsort`` and ``lax.top_k`` do. Random-weight
detectors score many boxes exactly 1.0, so tie order decides the output.

Only hard ("greedy") NMS is ported; Soft-NMS and box voting are ROADMAP
Queue 1 item 15.
"""

from __future__ import annotations

import torch

from .boxes import pairwise_iou


def _sort_desc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last dim; ties keep the lower index first."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last dim (ties: lower index first)."""
    vals, idx = _sort_desc(x)
    return vals[..., :k], idx[..., :k]


def nms_mask_sorted_plain(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thr: float) -> torch.Tensor:
    """Greedy keep mask of SCORE-SORTED problems: boxes (P, N, 4), valid (P, N)
    -> keep (P, N) bool. Row i, if still kept, suppresses every later j with
    IoU(i, j) > iou_thr."""
    n = boxes.shape[-2]
    iou = pairwise_iou(boxes.float(), boxes.float())  # (P, N, N)
    over = iou > iou_thr
    later = torch.arange(n, device=boxes.device)
    keep = valid.clone()
    for i in range(n):
        suppress = keep[:, i, None] & (later > i) & over[:, i, :]
        keep &= ~suppress
    return keep


def nms_mask_sorted(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Device dispatch of the sorted greedy keep mask, (P, N, 4) -> (P, N)."""
    if boxes.device.type == "cpu":
        return nms_mask_sorted_plain(boxes, valid, iou_thr)
    if boxes.device.type == "cuda":
        from .cuda.nms import nms_mask_sorted_cuda

        return nms_mask_sorted_cuda(boxes, valid, iou_thr)
    raise RuntimeError(f"nms: no implementation for device {boxes.device}")


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact greedy NMS keep mask aligned with the inputs.

    boxes (..., N, 4), scores (..., N); padding rows carry score=-inf or
    valid=False.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    _, order = _sort_desc(scores)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    valid_s = torch.gather(valid, -1, order)
    keep_s = nms_mask_sorted(boxes_s.reshape(-1, n, 4), valid_s.reshape(-1, n), iou_thr)
    keep = torch.zeros_like(valid_s)
    return keep.scatter_(-1, order, keep_s.reshape(*lead, n))


def _select_top(boxes, masked_scores, keep, max_out):
    """Top-``max_out`` kept rows -> (idx, boxes, scores, valid), padded with
    invalid rows when fewer than ``max_out`` candidates exist."""
    out_scores = torch.where(keep, masked_scores, torch.full_like(masked_scores, -float("inf")))
    n = out_scores.shape[-1]
    if max_out > n:
        pad = out_scores.new_full((*out_scores.shape[:-1], max_out - n), -float("inf"))
        out_scores = torch.cat([out_scores, pad], dim=-1)
    top_scores, idx = topk_stable(out_scores, max_out)
    idx = idx.clamp(max=n - 1)
    out_valid = top_scores > -float("inf")
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_scores = torch.where(out_valid, top_scores, torch.zeros_like(top_scores))
    return idx, out_boxes, out_scores, out_valid


def _mask_scores(scores, valid, score_thr):
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    valid = valid & (scores > score_thr)
    masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    return valid, masked


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float, max_out: int,
        valid: torch.Tensor | None = None, score_thr: float = -float("inf")):
    """NMS returning fixed-size top-``max_out`` (boxes, scores, valid_mask),
    batched over leading dims."""
    valid, masked = _mask_scores(scores, valid, score_thr)
    keep = nms_mask(boxes, masked, iou_thr, valid)
    _, out_boxes, out_scores, out_valid = _select_top(boxes, masked, keep, max_out)
    return out_boxes, out_scores, out_valid


def class_offsets(boxes: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Per-problem coordinate offset: NaN-scrubbed max over valid rows + 1,
    shape (..., 1, 1) to broadcast against (..., N, 4)."""
    safe = boxes if valid is None else torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    m = safe.amax(dim=(-2, -1), keepdim=True)
    return torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0) + 1.0


def class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                    iou_thr: float, max_out: int, valid: torch.Tensor | None = None,
                    score_thr: float = -float("inf")):
    """Per-class NMS via the coordinate-offset trick, batched over leading dims.

    boxes (..., N, 4), scores (..., N), labels (..., N) int. Returns
    fixed-size (boxes, scores, labels, valid) of length ``max_out``,
    score-sorted. The offset is max(valid boxes)+1 per problem, so shifted
    coordinates stay small enough that float32 ulp never perturbs IoU.
    """
    shifted = boxes + labels.to(boxes.dtype)[..., None] * class_offsets(boxes, valid)
    valid, masked = _mask_scores(scores, valid, score_thr)
    keep = nms_mask(shifted, masked, iou_thr, valid)
    idx, out_boxes, out_scores, out_valid = _select_top(boxes, masked, keep, max_out)
    out_labels = torch.where(out_valid, torch.gather(labels, -1, idx),
                             torch.full_like(idx, -1).to(labels.dtype))
    return out_boxes, out_scores, out_labels, out_valid


def class_aware_nms_from_cfg(t, boxes: torch.Tensor, scores: torch.Tensor,
                             labels: torch.Tensor, valid: torch.Tensor | None = None):
    """Test-time class-aware NMS by ``TestCfg.nms_method``. Only "greedy" is
    ported; Soft-NMS and box voting wait for ROADMAP Queue 1 item 15."""
    if t.nms_method.startswith("soft_"):
        raise NotImplementedError(
            f"test.nms_method={t.nms_method!r} is not ported yet "
            "(ROADMAP Queue 1 item 15: Soft-NMS and box voting)")
    if t.nms_method != "greedy":
        raise ValueError(f"unknown test.nms_method {t.nms_method!r}")
    if getattr(t, "bbox_vote", False):
        raise NotImplementedError(
            "test.bbox_vote is not ported yet (ROADMAP Queue 1 item 15: "
            "Soft-NMS and box voting)")
    return class_aware_nms(boxes, scores, labels, t.nms_thr, t.max_per_image,
                           valid=valid, score_thr=t.score_thr)
