"""Detection losses — port of ``mxdetection_tpu.losses.losses``.

Plain elementwise and reduction chains, as in the JAX package. The focal
loss (RetinaNet), the mask BCE (Mask R-CNN) and OHEM (R-FCN) come with
their detectors (ROADMAP Queue 1 items 11, 12 and 14).
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


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over valid rows: logits (N, C), labels
    (N,) int (any value where invalid), valid (N,) bool."""
    logp = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)
