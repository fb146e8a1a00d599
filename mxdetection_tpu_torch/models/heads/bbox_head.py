"""Fast R-CNN 2fc-1024 bbox head — port of ``mxdetection_tpu.models.heads.bbox_head``.

Classification is (C+1)-way softmax with background at index 0. RoI features
arrive channels-last, (R, P, P, C), and are flattened in that (H, W, C)
order, as the JAX head does, so ``fc1`` needs no row permutation. The mask
head is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Linear, init_layer_


class BBoxHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 80, fc_channels: int = 1024,
                 class_agnostic: bool = False):
        super().__init__()
        self.fc1 = Linear(in_features, fc_channels)
        self.fc2 = Linear(fc_channels, fc_channels)
        self.cls_score = Linear(fc_channels, num_classes + 1)
        self.bbox_pred = Linear(fc_channels, 4 if class_agnostic else 4 * (num_classes + 1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_layer_(self.fc1, "xavier", gen)
        init_layer_(self.fc2, "xavier", gen)
        init_layer_(self.cls_score, "normal", gen, std=0.01)
        init_layer_(self.bbox_pred, "normal", gen, std=0.001)

    def forward(self, roi_feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(R, P, P, C) -> (cls_logits (R, C+1), deltas (R, 4 or 4(C+1))), f32."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()
