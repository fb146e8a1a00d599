"""Fast R-CNN 2fc-1024 bbox head and Mask R-CNN mask head — port of
``mxdetection_tpu.models.heads.bbox_head``.

Classification is (C+1)-way softmax with background at index 0. RoI features
arrive channels-last, (R, P, P, C), and are flattened in that (H, W, C)
order, as the JAX head does, so ``fc1`` needs no row permutation. The mask
head takes the same channels-last features as an NCHW view (channels-last
memory, no copy) and returns its logits channels-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvTranspose2d, Linear, conv, init_layer_


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


class MaskHead(nn.Module):
    """``num_convs`` x (3x3 conv ``channels`` + bias, ReLU), a 2x2 stride-2
    transposed conv + ReLU, and a 1x1 conv to one logit a class:
    (R, P, P, C_in) -> (R, 2P, 2P, num_classes) f32 logits. Computes in its
    input's dtype."""

    def __init__(self, in_channels: int, num_classes: int = 80, num_convs: int = 4,
                 channels: int = 256):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"mask_conv{i}", conv(in_channels if i == 0 else channels, channels,
                                                  3, use_bias=True))
        self.mask_deconv = ConvTranspose2d(channels if num_convs else in_channels, channels, 2,
                                           stride=2)
        self.mask_pred = conv(channels, num_classes, 1, use_bias=True)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for i in range(self.num_convs):
            init_layer_(getattr(self, f"mask_conv{i}"), "he_normal", gen)
        init_layer_(self.mask_deconv, "he_normal", gen)
        init_layer_(self.mask_pred, "normal", gen, std=0.001)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"mask_conv{i}")(x))
        x = self.mask_pred(F.relu(self.mask_deconv(x)))
        return x.permute(0, 2, 3, 1).float()
