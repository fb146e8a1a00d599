"""Detection losses — port of ``mxdetection_tpu.losses.losses``.

Plain elementwise and reduction chains, as in the JAX package: the
smooth-L1, softmax CE and mask BCE of the R-CNN family, RetinaNet's sigmoid
focal loss, and R-FCN's online hard example mining (``ohem_select``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber / smooth-L1 with transition point ``beta``."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (RetinaNet), ``targets`` in {0, 1}, in
    the log-sigmoid form the JAX function writes, term for term."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * ((1.0 - p_t) ** gamma) * ce


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over valid rows: logits (N, C), labels
    (N,) int (any value where invalid), valid (N,) bool."""
    logp = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def mask_bce_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Mask R-CNN's per-roi mask BCE, averaged over each roi's pixels, then
    over the valid rois: mask_logits (..., R, S, S), the slice of each roi's
    gt class; targets in {0, 1}; valid (..., R) -> (...). In f32."""
    x, t = mask_logits.float(), mask_targets.float()
    ce = -(t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))
    per_roi = torch.where(valid, ce.mean((-1, -2)), 0.0)
    return per_roi.sum(-1) / valid.sum(-1).clamp(min=1)


def ohem_select(per_roi_loss: torch.Tensor, valid: torch.Tensor, keep: int) -> torch.Tensor:
    """Online hard example mining along the last dim: the mask of the
    ``keep`` highest-loss valid rois. The rank is ``argsort(argsort(-masked))``
    with stable sorts, as ``jnp.argsort``: of equal losses the lower index
    ranks first. Returns a bool mask (no gradient)."""
    masked = torch.where(valid, per_roi_loss.detach(), -float("inf"))
    order = torch.argsort(-masked, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return valid & (rank < keep)
