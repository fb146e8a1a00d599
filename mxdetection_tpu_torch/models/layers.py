"""Shared NN building blocks — port of ``mxdetection_tpu.models.layers``:
the norms (FrozenBN, SyncBN, GroupNorm), convs and the seeded initialisers.

Modules of the port take and return NCHW tensors in ``channels_last`` memory
inside the network (so every NHWC view is contiguous for free); the public
detector functions keep the JAX package's NHWC layout.

Parameters are cast to the input's dtype when read (``Conv2d``,
``ConvTranspose2d``, ``Linear``, ``FrozenBatchNorm``), as flax's
``param_dtype=float32, dtype=bfloat16`` does: a training model keeps f32
master weights and computes in the config's dtype, and the gradients reach
the f32 weights through the cast.

Seeded initialisers mirror flax's: ``he_normal`` (truncated normal, fan-in,
scale 2), ``xavier_uniform`` and ``normal(std)``, drawn from a
``torch.Generator``. The two frameworks give different numbers from one seed.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from ..ops.norm_act import frozen_bn_act
from ..parallel.mesh import world_size

# flax's truncated-normal initialisers divide the std by the std of a
# standard normal truncated to [-2, 2], so the drawn values keep the variance
_TRUNC_STD = 0.87962566103423978


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics AND frozen affine params:
    ``y = x * scale + bias`` from stored (gamma, beta, mean, var) buffers.
    scale/bias are computed in f32 and cast to the input dtype before the
    multiply-add, as the JAX module does, so the output keeps the input's
    dtype: an f32 scale would promote bf16 activations to f32."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("gamma", torch.ones(channels))
        self.register_buffer("beta", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def affine(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias), each (C,), computed in f32 and cast to ``dtype``."""
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + self.epsilon)
        bias = self.beta.float() - self.mean.float() * scale
        return scale.to(dtype), bias.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: (B, C, H, W)
        scale, bias = self.affine(x.dtype)
        shape = (1, -1, 1, 1)
        return x * scale.view(shape) + bias.view(shape)

    def act(self, x: torch.Tensor, residual: torch.Tensor | None = None,
            residual_bn: FrozenBatchNorm | None = None) -> torch.Tensor:
        """``relu(self(x) [+ residual or residual_bn(residual)])`` in one call
        of the operator ``mxdet::frozen_bn_act`` (``ops/norm_act.py``): one
        pass of a kernel on the card, the same bits as the modules' op
        sequence."""
        scale, bias = self.affine(x.dtype)
        res_scale, res_bias = (None, None) if residual_bn is None else residual_bn.affine(x.dtype)
        return frozen_bn_act(x, scale, bias, residual, res_scale, res_bias)


class SyncBatchNorm(nn.Module):
    """Cross-replica BatchNorm with the JAX layer's semantics, which are not
    ``torch.nn.SyncBatchNorm``'s.

    Train mode: ``mean = E[x]`` and ``mean2 = E[x^2]`` over (B, H, W) in f32;
    with ``sync`` and a process group of more than one replica both are
    averaged over the replicas (the unweighted mean of the per-replica
    means, as ``lax.pmean``: the replicas must hold equal local batches, which
    ``Trainer`` checks); ``var = max(mean2 - mean^2, 0)``, biased; the running
    statistics move as ``ra = 0.9 ra + 0.1 batch``. Without a group, or at
    world size 1, it is plain train-mode BN over the local batch, as the JAX
    layer outside a mapped context. Eval mode reads the running statistics.

    The average is ``torch.distributed.nn.functional.all_reduce``, whose
    backward sums the replicas' cotangents as the transpose of ``pmean``
    does: once the trainer averages the gradients, each replica's dx is the
    gradient of the mean loss. ``gamma``/``beta`` are f32 parameters (the
    optimizer decays them, as optax does); ``mean``/``var`` are buffers.
    ``update_stats=False`` (set while a remat'd block recomputes its forward)
    leaves the running statistics alone, so they move once a step.
    """

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 sync: bool = True):
        super().__init__()
        self.momentum, self.epsilon, self.sync = momentum, epsilon, sync
        self.update_stats = True
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: (B, C, H, W)
        if not self.training:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            stats = torch.stack([xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))])
            n = world_size() if self.sync else 1
            if n > 1:
                stats = dist_nn.all_reduce(stats) / n
            mean, mean2 = stats[0], stats[1]
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        scale = self.gamma * torch.rsqrt(var + self.epsilon)
        bias = self.beta - mean * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)``: statistics per (image, group) over
    (H, W, C/G) in f32 with the fast variance ``max(E[x^2] - E[x]^2, 0)``,
    ``(x - mean) * (rsqrt(var + eps) * gamma) + beta`` in f32, cast to x's
    dtype. ``gamma``/``beta`` are f32 parameters (flax's ``scale``/``bias``)."""

    def __init__(self, channels: int, num_groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups, self.epsilon = num_groups, epsilon
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: (B, C, H, W)
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.num_groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp(xg.square().mean(-1) - mean.square(), min=0.0)
        mean = mean.repeat_interleave(c // self.num_groups, 1).view(b, c, 1, 1)
        var = var.repeat_interleave(c // self.num_groups, 1).view(b, c, 1, 1)
        mul = torch.rsqrt(var + self.epsilon) * self.gamma.view(1, c, 1, 1)
        return ((x - mean) * mul + self.beta.view(1, c, 1, 1)).to(x.dtype)


NORMS = (FrozenBatchNorm, SyncBatchNorm, GroupNorm)


def make_norm(kind: str) -> Callable[[int], nn.Module]:
    """Norm factory keyed by the config string, ``channels -> module``. The
    JAX factory's ``train`` flag is the module's train/eval mode here."""
    if kind == "frozen_bn":
        return FrozenBatchNorm
    if kind == "sync_bn":
        return SyncBatchNorm
    if kind == "bn":
        return lambda channels: SyncBatchNorm(channels, sync=False)
    if kind == "gn":
        return GroupNorm
    raise ValueError(f"unknown norm {kind!r}")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (weights cast on read)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype (weights cast on
    read). Its weight is (in, out, kh, kw)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (weights cast on read)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def conv(in_channels: int, features: int, kernel: int = 3, stride: int = 1, *,
         dilation: int = 1, use_bias: bool = False) -> Conv2d:
    """Conv with the JAX helper's symmetric padding ``dilation * (kernel // 2)``
    and no bias by default."""
    return Conv2d(in_channels, features, kernel, stride=stride,
                  padding=dilation * (kernel // 2), dilation=dilation, bias=use_bias)


@torch.no_grad()
def he_normal_(w: torch.Tensor, gen: torch.Generator, fan_in: int | None = None) -> None:
    """flax ``he_normal``: truncated normal in [-2, 2] std, std sqrt(2/fan_in).
    ``fan_in`` defaults to a Conv2d/Linear weight's, ``w[0].numel()``."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    t = torch.empty(w.shape).normal_(generator=gen)
    while True:  # resample the tails: a truncated normal by rejection
        bad = t.abs() > 2.0
        if not bad.any():
            break
        t[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
    w.copy_(t * std)


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax ``xavier_uniform``: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    rf = w[0, 0].numel() if w.dim() > 2 else 1
    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w.copy_(torch.empty(w.shape).uniform_(-a, a, generator=gen))


@torch.no_grad()
def normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    w.copy_(torch.empty(w.shape).normal_(0.0, std, generator=gen))


@torch.no_grad()
def init_layer_(m: nn.Module, kind: str, gen: torch.Generator, std: float = 0.01) -> None:
    """Initialise a Conv2d/ConvTranspose2d/Linear weight by ``kind``
    (he_normal | xavier | normal) and zero its bias, on the CPU generator, in
    place. A transposed conv's fan-in is in-channels x kh x kw, as flax
    counts it for a ``ConvTranspose`` kernel (kh, kw, in, out)."""
    if kind == "he_normal":
        w = m.weight
        he_normal_(w, gen, w.shape[0] * w[0, 0].numel()
                   if isinstance(m, nn.ConvTranspose2d) else None)
    elif kind == "xavier":
        xavier_uniform_(m.weight, gen)
    elif kind == "normal":
        normal_(m.weight, std, gen)
    else:
        raise ValueError(f"unknown init {kind!r}")
    if m.bias is not None:
        m.bias.zero_()
