"""FPN neck: lateral 1x1 + top-down 2x upsample + 3x3 smooth — port of
``mxdetection_tpu.models.necks.fpn``. Above P5, ``extra_convs="pool"`` (the
R-CNN variant) adds P6 as the stride-2 subsample of P5; ``extra_convs="conv"``
(RetinaNet) adds P6 as a 3x3 stride-2 conv of C5 and each further level as a
3x3 stride-2 conv of the ReLU of the one below.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import conv, init_layer_

# ResNet-50/101 C2..C5 widths
BACKBONE_CHANNELS = (256, 512, 1024, 2048)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) by nearest neighbour."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    """(C2..C5) NHWC -> [P_min .. P_max] NHWC, ``out_channels`` each."""

    def __init__(self, out_channels: int = 256, min_level: int = 2, max_level: int = 6,
                 extra_convs: str = "pool", in_channels=BACKBONE_CHANNELS):
        super().__init__()
        if extra_convs not in ("pool", "conv"):
            raise ValueError(f"unknown extra_convs {extra_convs!r}")
        if max_level > 6 and extra_convs == "pool":
            raise ValueError("pool variant only adds P6")
        self.min_level, self.max_level, self.extra_convs = min_level, max_level, extra_convs
        self.hi_backbone = min(max_level, 5)
        for lv in range(min_level, self.hi_backbone + 1):
            self.add_module(f"lateral_p{lv}", conv(in_channels[lv - 2], out_channels, 1,
                                                   use_bias=True))
            self.add_module(f"smooth_p{lv}", conv(out_channels, out_channels, 3, use_bias=True))
        if extra_convs == "conv":
            for lv in range(6, max_level + 1):
                self.add_module(f"extra_p{lv}", conv(in_channels[3] if lv == 6 else out_channels,
                                                     out_channels, 3, 2, use_bias=True))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_layer_(m, "xavier", gen)

    def forward(self, feats: Sequence[torch.Tensor]) -> list:
        lo, hi = self.min_level, self.hi_backbone
        c = {i + 2: f.permute(0, 3, 1, 2) for i, f in enumerate(feats)}
        lat = {lv: getattr(self, f"lateral_p{lv}")(c[lv]) for lv in range(lo, hi + 1)}
        for lv in range(hi - 1, lo - 1, -1):  # top-down pathway
            lat[lv] = lat[lv] + upsample2x_nearest(lat[lv + 1])
        outs = {lv: getattr(self, f"smooth_p{lv}")(lat[lv]) for lv in range(lo, hi + 1)}
        if self.max_level >= 6 and self.extra_convs == "pool":
            outs[6] = outs[5][:, :, ::2, ::2]  # max_pool 1x1 / stride 2
        elif self.max_level >= 6:
            outs[6] = self.extra_p6(c[5])
            for lv in range(7, self.max_level + 1):
                outs[lv] = getattr(self, f"extra_p{lv}")(F.relu(outs[lv - 1]))
        return [outs[lv].permute(0, 2, 3, 1) for lv in range(lo, self.max_level + 1)]
