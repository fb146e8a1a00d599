"""ResNet-50/101 (v1b) backbone — port of ``mxdetection_tpu.models.backbones.resnet``.

v1b: the stride of a downsampling bottleneck sits on its 3x3 conv. The stem
is the plain 7x7/2 conv + 3x3/2 max-pool; the JAX package's opt-in
space-to-depth stem is a TPU measure and is not ported.

Deformable stages (``dcn_stages``): their 3x3 is a ``DeformConv``, whose
offsets come from an f32 conv and whose sampling and product run in the
operator ``mxdet::deform_conv2d`` (``ops/dcn.py``, ``ops/library.py``; on
the card the kernels K5/K5b forward, K6/K6b and K7/K7b backward; on the
CPU their plain versions). The gradient
reaches the layer's input through both branches: the sampling's dx and the
offset conv's input gradient.

Frozen stages: the activations are detached exactly where the JAX module
puts ``stop_gradient``, after the stem's ReLU (when ``frozen_stages >= 0``)
and after every stage up to ``frozen_stages`` (so with the default 1, C2
itself is detached). The frozen weights stay parameters and get no
gradient; the trainer still decays them, as optax does in the reference.

Norms (``norm_kind``, ``layers.make_norm``) sit at the stem and at every
block's ``bn1``-``bn3`` and ``downsample_bn``. FrozenBN runs with the ReLU
and the residual add after it as one operator call
(``FrozenBatchNorm.act``, ``mxdet::frozen_bn_act``): the stem's, and three a
block (bn1 and bn2 with their ReLU; bn3 with the residual, the downsample
BN and the last ReLU); SyncBN and GroupNorm keep the modules' op sequence.
The JAX module's ``train`` flag, which switches SyncBN to batch statistics,
is the module's train/eval mode here. ``remat`` recomputes each bottleneck
in the backward (``torch.utils.checkpoint``, as ``nn.remat(Bottleneck)``) in
train mode; the recompute leaves SyncBN's running statistics alone, so they
move once a step, as flax's ``batch_stats`` come from the forward pass
alone.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.dcn import deform_conv2d_batched
from ..layers import (Conv2d, FrozenBatchNorm, SyncBatchNorm, conv, he_normal_, init_layer_,
                      make_norm)

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class DeformConv(nn.Module):
    """3x3 deformable conv: a regular 3x3 conv with bias (``offset_conv``,
    18 outputs, the layer's stride and dilation, padding ``dilation``)
    predicts the per-tap (dy, dx) offsets, which feed ``ops/dcn.py``.

    As in the JAX layer, the offset conv computes in float32 on ``x.float()``
    whatever the model's dtype (``build_detector`` keeps its parameters f32)
    and is zero-initialised; ``weight`` is (Cout, Cin, 3, 3) and computes in
    x's dtype. Takes and returns NCHW tensors in channels_last memory.
    """

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.offset_conv = Conv2d(in_channels, 2 * 9, 3, stride=stride, padding=dilation,
                                  dilation=dilation, bias=True)
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))

    def reset_parameters(self, gen: torch.Generator) -> None:
        he_normal_(self.weight, gen)
        with torch.no_grad():
            self.offset_conv.weight.zero_()
            self.offset_conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # An 18-channel conv output need not be channels_last: make the NHWC
        # offsets contiguous on purpose (a no-op when they already are).
        offsets = self.offset_conv(x.float()).permute(0, 2, 3, 1).contiguous()
        out = deform_conv2d_batched(
            x.permute(0, 2, 3, 1).contiguous(), offsets,
            self.weight.to(x.dtype).permute(2, 3, 1, 0), stride=self.stride,
            dilation=self.dilation)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1 with identity/projection
    shortcut; the 3x3 is a ``DeformConv`` with ``use_dcn``."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 use_dcn: bool = False, norm: Callable[[int], nn.Module] = FrozenBatchNorm,
                 dilation: int = 1):
        super().__init__()
        out = channels * 4
        self.conv1 = conv(in_channels, channels, 1)
        self.bn1 = norm(channels)
        self.conv2 = (DeformConv(channels, channels, stride, dilation) if use_dcn
                      else conv(channels, channels, 3, stride, dilation=dilation))
        self.bn2 = norm(channels)
        self.conv3 = conv(channels, out, 1)
        self.bn3 = norm(out)
        # the JAX block projects when the residual's shape differs from the output's
        if stride != 1 or in_channels != out:
            self.downsample_conv = conv(in_channels, out, 1, stride)
            self.downsample_bn = norm(out)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.bn1, FrozenBatchNorm):  # the norm, the ReLU and the add fused
            out = self.bn1.act(self.conv1(x))
            out = self.bn2.act(self.conv2(out))
            if self.downsample_conv is None:
                return self.bn3.act(self.conv3(out), x)
            return self.bn3.act(self.conv3(out), self.downsample_conv(x), self.downsample_bn)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """While a checkpointed block recomputes its forward: SyncBN's running
    statistics stay as the forward pass left them."""
    norms = [m for m in block.modules() if isinstance(m, SyncBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class ResNet(nn.Module):
    """(B, H, W, 3) NHWC image -> (C2, C3, C4, C5) NHWC maps at strides 4..32.

    ``dilated_c5`` (R-FCN): stage 4 runs at stride 1 with dilation 2 in every
    block's 3x3 (padding 2), so C5 stays at stride 16; its first block's
    projection is then a stride-1 1x1."""

    def __init__(self, depth: int = 50, norm_kind: str = "frozen_bn", frozen_stages: int = 1,
                 dcn_stages: Sequence[bool] = (False, False, False, False),
                 s2d_stem: bool = False, dilated_c5: bool = False, remat: bool = False):
        super().__init__()
        if s2d_stem:
            raise NotImplementedError("the space-to-depth stem is a TPU measure and is not ported")
        self.frozen_stages, self.remat = frozen_stages, remat
        norm = make_norm(norm_kind)
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = norm(64)
        in_ch = 64
        self.block_names = []
        for stage, (n_blocks, width) in enumerate(zip(STAGE_BLOCKS[depth], (64, 128, 256, 512))):
            names = []
            dilated = stage == 3 and dilated_c5
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0 and not dilated) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, Bottleneck(in_ch, width, stride,
                                                 use_dcn=bool(dcn_stages[stage]), norm=norm,
                                                 dilation=2 if dilated else 1))
                in_ch = width * 4
                names.append(name)
            self.block_names.append(names)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """he_normal for every conv, as flax (a DeformConv's offset conv
        zero, as the JAX layer's); every norm identity except the
        last of each block, whose gamma is 1/sqrt(number of blocks), so
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
        for m in self.modules():  # after the loop above, which also visits offset_conv
            if isinstance(m, DeformConv):
                m.reset_parameters(gen)
        gamma = len(sum(self.block_names, [])) ** -0.5
        with torch.no_grad():  # SyncBN's and GroupNorm's gamma is a parameter
            for names in self.block_names:
                for name in names:
                    getattr(self, name).bn3.gamma.fill_(gamma)

    def forward(self, images: torch.Tensor) -> tuple:
        x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory == channels_last
        x = self.stem_conv(x)
        x = (self.stem_bn.act(x) if isinstance(self.stem_bn, FrozenBatchNorm)
             else F.relu(self.stem_bn(x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as flax does
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage, names in enumerate(self.block_names):
            for name in names:
                block = getattr(self, name)
                if remat:
                    x = checkpoint(block, x, use_reentrant=False, context_fn=lambda b=block: (
                        contextlib.nullcontext(), _recomputing(b)))
                else:
                    x = block(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
