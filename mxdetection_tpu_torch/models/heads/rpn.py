"""RPN head: shared 3x3 conv + 1x1 objectness/regression over all FPN levels —
port of ``mxdetection_tpu.models.heads.rpn`` (A-sigmoid objectness)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import conv, init_layer_


class RPNHead(nn.Module):
    """``in_channels`` is the width of the maps it reads (default
    ``channels``): R-FCN's 512-wide head reads the 1024-wide C4."""

    def __init__(self, num_anchors: int = 3, channels: int = 256,
                 in_channels: int | None = None):
        super().__init__()
        self.rpn_conv = conv(channels if in_channels is None else in_channels, channels, 3,
                             use_bias=True)
        self.rpn_cls = conv(channels, num_anchors, 1, use_bias=True)
        self.rpn_reg = conv(channels, num_anchors * 4, 1, use_bias=True)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            init_layer_(m, "normal", gen, std=0.01)

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[list, list]:
        """Per level NHWC (B, H, W, C) -> ([(B, H, W, A)], [(B, H, W, 4A)]),
        flattening as (H, W, A[, 4]) to line up with the anchors."""
        cls_logits, bbox_deltas = [], []
        for f in feats:
            x = F.relu(self.rpn_conv(f.permute(0, 3, 1, 2)))
            cls_logits.append(self.rpn_cls(x).permute(0, 2, 3, 1))
            bbox_deltas.append(self.rpn_reg(x).permute(0, 2, 3, 1))
        return cls_logits, bbox_deltas
