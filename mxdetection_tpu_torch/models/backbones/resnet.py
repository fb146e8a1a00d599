"""ResNet-50/101 (v1b) backbone — port of ``mxdetection_tpu.models.backbones.resnet``.

v1b: the stride of a downsampling bottleneck sits on its 3x3 conv. The stem
is the plain 7x7/2 conv + 3x3/2 max-pool; the JAX package's opt-in
space-to-depth stem is a TPU measure and is not ported. Deformable stages
are ROADMAP Queue 1 item 13.

Frozen stages: the activations are detached exactly where the JAX module
puts ``stop_gradient``, after the stem's ReLU (when ``frozen_stages >= 0``)
and after every stage up to ``frozen_stages`` (so with the default 1, C2
itself is detached). The frozen weights stay parameters and get no
gradient; the trainer still decays them, as optax does in the reference.
The JAX module's ``train`` flag only switches SyncBN to batch statistics;
FrozenBN, the one norm ported, is the same in training and evaluation, so
this module has no such flag until SyncBN comes (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, FrozenBatchNorm, conv, init_layer_

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 with identity/projection shortcut."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        out = channels * 4
        self.conv1 = conv(in_channels, channels, 1)
        self.bn1 = FrozenBatchNorm(channels)
        self.conv2 = conv(channels, channels, 3, stride)
        self.bn2 = FrozenBatchNorm(channels)
        self.conv3 = conv(channels, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        # the JAX block projects when the residual's shape differs from the output's
        if stride != 1 or in_channels != out:
            self.downsample_conv = conv(in_channels, out, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """(B, H, W, 3) NHWC image -> (C2, C3, C4, C5) NHWC maps at strides 4..32."""

    def __init__(self, depth: int = 50, norm_kind: str = "frozen_bn", frozen_stages: int = 1,
                 dcn_stages: Sequence[bool] = (False, False, False, False),
                 s2d_stem: bool = False, dilated_c5: bool = False, remat: bool = False):
        super().__init__()
        if norm_kind != "frozen_bn":
            raise NotImplementedError(f"backbone norm {norm_kind!r} is not ported yet "
                                      "(ROADMAP Queue 1 item 10: SyncBN)")
        if any(dcn_stages):
            raise NotImplementedError("deformable stages are not ported yet "
                                      "(ROADMAP Queue 1 item 13: Cascade R-CNN DCN)")
        if s2d_stem:
            raise NotImplementedError("the space-to-depth stem is a TPU measure and is not ported")
        if dilated_c5:
            raise NotImplementedError("dilated C5 is not ported yet (ROADMAP Queue 1 item 14: R-FCN)")
        if remat:
            raise NotImplementedError("backbone.remat is not ported yet (ROADMAP Queue 1 item 10)")
        self.frozen_stages = frozen_stages
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        in_ch = 64
        self.block_names = []
        for stage, (n_blocks, width) in enumerate(zip(STAGE_BLOCKS[depth], (64, 128, 256, 512))):
            names = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, Bottleneck(in_ch, width, stride))
                in_ch = width * 4
                names.append(name)
            self.block_names.append(names)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """he_normal for every conv, as flax; FrozenBN identity except the
        last BN of each block, whose gamma is 1/sqrt(number of blocks), so
        the variance of the residual sum grows by a bounded factor over the
        whole network instead of doubling at every block.

        Deviation from the JAX init, which leaves every FrozenBN at identity:
        there, random activations grow through the 16 residual blocks to a
        pyramid of ~5e3 on a normalised 8x832x1344 batch, and 7925 of its
        8000 RPN proposals clip to empty boxes, so RoIAlign and NMS would
        mostly process padding (H100, seed 0). Each residual branch still
        contributes to the output, so every conv of the backbone is seen by
        a check of the detections. Converted weights are unaffected.
        """
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_layer_(m, "he_normal", gen)
        gamma = len(sum(self.block_names, [])) ** -0.5
        for names in self.block_names:
            for name in names:
                getattr(self, name).bn3.gamma.fill_(gamma)

    def forward(self, images: torch.Tensor) -> tuple:
        x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory == channels_last
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as flax does
        outs = []
        for stage, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
