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

Soft-NMS (``soft_nms``, ``class_aware_soft_nms``) and box voting
(``box_voting``) are the test-time options of ``class_aware_nms_from_cfg``.
The JAX package runs Soft-NMS as a ``lax.scan`` of ``max_out`` picks with no
Pallas kernel, so the port runs the same picks as plain torch ops on either
device: each pick is an argmax, a gather, an IoU row, a decay and a scatter
over every problem of the batch at once.
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


def _soft_nms_scan(iou_boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                   method: str, iou_thr: float, sigma: float,
                   valid: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Soft-NMS pick loop over problems (..., N) -> (picked indices,
    picked scores), each (..., max_out).

    Each pick takes the current score argmax (the first index among equal
    scores, as ``jnp.argmax``), emits it, and decays every remaining score by
    f(IoU with the pick). Decay only lowers scores, so the emitted scores are
    non-increasing and ``max_out`` picks are the top ``max_out`` of the whole
    algorithm.
    """
    if method not in ("linear", "gaussian"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    neg_inf = torch.tensor(-float("inf"), device=scores.device)
    s = torch.where(valid, scores.float(), neg_inf)
    bxs = iou_boxes.float()
    area = (bxs[..., 2] - bxs[..., 0]).clamp(min=0) * (bxs[..., 3] - bxs[..., 1]).clamp(min=0)
    picks, picked = [], []
    for _ in range(max_out):
        i = torch.argmax(s, dim=-1, keepdim=True)                     # (..., 1)
        picks.append(i)
        picked.append(torch.gather(s, -1, i))
        bi = torch.gather(bxs, -2, i[..., None].expand(*i.shape, 4))  # (..., 1, 4)
        lt = torch.maximum(bxs[..., :2], bi[..., :2])
        rb = torch.minimum(bxs[..., 2:], bi[..., 2:])
        wh = (rb - lt).clamp(min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area + torch.gather(area, -1, i) - inter).clamp(min=1e-12)
        if method == "linear":
            decay = torch.where(iou > iou_thr, 1.0 - iou, torch.ones_like(iou))
        else:
            decay = torch.exp(-(iou * iou) / sigma)
        # -inf (padding, picked) stays -inf where decay is 0 (identical
        # boxes): -inf * 0 would be NaN
        s = torch.where(torch.isfinite(s), s * decay, neg_inf)
        s = s.scatter(-1, i, neg_inf.expand(i.shape))
    return torch.cat(picks, -1), torch.cat(picked, -1)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int, *,
             method: str = "linear", iou_thr: float = 0.3, sigma: float = 0.5,
             score_thr: float = 1e-3, valid: torch.Tensor | None = None):
    """Soft-NMS (Bodla et al. 2017) batched over leading dims: overlapping
    scores decay instead of dying. boxes (..., N, 4), scores (..., N) ->
    fixed-size (boxes, scores, valid) of length ``max_out``; picks decayed to
    ``score_thr`` or below are dropped; the picked boxes are not moved."""
    idx, svals = _soft_nms_scan(boxes, scores, max_out, method, iou_thr, sigma, valid)
    out_valid = svals > score_thr
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    return out_boxes, torch.where(out_valid, svals, torch.zeros_like(svals)), out_valid


def class_aware_soft_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                         max_out: int, *, method: str = "linear", iou_thr: float = 0.3,
                         sigma: float = 0.5, score_thr: float = 1e-3,
                         valid: torch.Tensor | None = None):
    """Per-class Soft-NMS by ``class_aware_nms``'s coordinate offset, batched
    over leading dims: boxes of two classes never overlap, so they never
    decay each other. Returns (boxes, scores, labels, valid) of length
    ``max_out``, labels -1 where invalid."""
    shifted = boxes + labels.to(boxes.dtype)[..., None] * class_offsets(boxes, valid)
    idx, svals = _soft_nms_scan(shifted, scores, max_out, method, iou_thr, sigma, valid)
    out_valid = svals > score_thr
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_labels = torch.where(out_valid, torch.gather(labels, -1, idx),
                             torch.full_like(idx, -1).to(labels.dtype))
    return (out_boxes, torch.where(out_valid, svals, torch.zeros_like(svals)), out_labels,
            out_valid)


def box_voting(kept_boxes: torch.Tensor, kept_labels: torch.Tensor, kept_valid: torch.Tensor,
               pool_boxes: torch.Tensor, pool_scores: torch.Tensor, pool_labels: torch.Tensor,
               vote_thr: float, pool_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Box voting (Gidaris & Komodakis 2015), batched over leading dims: each
    kept box (..., K, 4) becomes the score-weighted mean of the pool's boxes
    (..., N, 4) of its class with IoU >= ``vote_thr``. Scores are left
    alone; a box with no weight, or invalid, keeps its coordinates."""
    if pool_valid is None:
        pool_valid = torch.ones_like(pool_scores, dtype=torch.bool)
    iou = pairwise_iou(kept_boxes, pool_boxes)                          # (..., K, N)
    same = kept_labels[..., :, None] == pool_labels[..., None, :]
    m = (iou >= vote_thr) & same & pool_valid[..., None, :] & kept_valid[..., :, None]
    w = torch.where(m, pool_scores.clamp(min=0.0)[..., None, :], torch.zeros_like(iou))
    num = w @ pool_boxes.to(w.dtype)                                    # (..., K, 4)
    den = w.sum(dim=-1, keepdim=True)
    voted = torch.where(den > 0, num / den.clamp(min=1e-12), kept_boxes)
    return torch.where(kept_valid[..., None], voted, kept_boxes)


def class_aware_nms_from_cfg(t, boxes: torch.Tensor, scores: torch.Tensor,
                             labels: torch.Tensor, valid: torch.Tensor | None = None):
    """Test-time class-aware NMS by ``TestCfg.nms_method`` ("greedy",
    "soft_linear" or "soft_gaussian"), then box voting over the candidates
    handed to this call when ``TestCfg.bbox_vote``; batched over leading dims."""
    if t.nms_method == "greedy":
        out = class_aware_nms(boxes, scores, labels, t.nms_thr, t.max_per_image,
                              valid=valid, score_thr=t.score_thr)
    elif t.nms_method.startswith("soft_"):
        out = class_aware_soft_nms(boxes, scores, labels, t.max_per_image,
                                   method=t.nms_method[len("soft_"):], iou_thr=t.nms_thr,
                                   sigma=t.soft_sigma, score_thr=t.score_thr, valid=valid)
    else:
        raise ValueError(f"unknown test.nms_method {t.nms_method!r}")
    if getattr(t, "bbox_vote", False):
        ob, os_, ol, ov = out
        ob = box_voting(ob, ol, ov, boxes, scores, labels, t.vote_thr, pool_valid=valid)
        out = (ob, os_, ol, ov)
    return out
