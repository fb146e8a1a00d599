"""RetinaNet head: shared cls/reg subnets over P3-P7 — port of
``mxdetection_tpu.models.heads.retina``.

Each subnet is ``stacked_convs`` x (3x3 conv + bias + ReLU) at ``channels``,
the same weights at every level; then ``cls_score`` (a 3x3 conv to A*C
logits, its bias ``-log((1 - pi) / pi)`` so the first focal loss is
stable) and ``bbox_pred`` (A*4 deltas). Dense convs, so cuDNN's, as the JAX
head leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import conv, init_layer_


class RetinaHead(nn.Module):
    def __init__(self, num_classes: int = 80, num_anchors: int = 9, stacked_convs: int = 4,
                 channels: int = 256, prior_prob: float = 0.01, in_channels: int = 256):
        super().__init__()
        self.stacked_convs, self.prior_prob = stacked_convs, prior_prob
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_conv{i}", conv(in_channels if i == 0 else channels,
                                                          channels, 3, use_bias=True))
        top = channels if stacked_convs else in_channels
        self.cls_score = conv(top, num_anchors * num_classes, 3, use_bias=True)
        self.bbox_pred = conv(top, num_anchors * 4, 3, use_bias=True)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_layer_(m, "normal", gen, std=0.01)
        with torch.no_grad():
            self.cls_score.bias.fill_(-math.log((1.0 - self.prior_prob) / self.prior_prob))

    def _subnet(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.stacked_convs):
            x = F.relu(getattr(self, f"{branch}_conv{i}")(x))
        return x

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[list, list]:
        """Per level NHWC (B, H, W, C) -> ([(B, H, W, A*num_classes)],
        [(B, H, W, A*4)]), flattening as (H, W, A[, C]) to line up with the
        anchors."""
        cls_logits, bbox_deltas = [], []
        for f in feats:
            x = f.permute(0, 3, 1, 2)
            cls_logits.append(self.cls_score(self._subnet("cls", x)).permute(0, 2, 3, 1))
            bbox_deltas.append(self.bbox_pred(self._subnet("reg", x)).permute(0, 2, 3, 1))
        return cls_logits, bbox_deltas
