"""Shared NN building blocks — port of ``mxdetection_tpu.models.layers``.

Modules of the port take and return NCHW tensors in ``channels_last`` memory
inside the network (so every NHWC view is contiguous for free); the public
detector functions keep the JAX package's NHWC layout.

Parameters are cast to the input's dtype when read (``Conv2d``, ``Linear``,
``FrozenBatchNorm``), as flax's ``param_dtype=float32, dtype=bfloat16``
does: a training model keeps f32 master weights and computes in the
config's dtype, and the gradients reach the f32 weights through the cast.

Seeded initialisers mirror flax's: ``he_normal`` (truncated normal, fan-in,
scale 2), ``xavier_uniform`` and ``normal(std)``, drawn from a
``torch.Generator``. The two frameworks give different numbers from one seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: (B, C, H, W)
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + self.epsilon)
        bias = self.beta.float() - self.mean.float() * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (weights cast on read)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
def he_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax ``he_normal``: truncated normal in [-2, 2] std, std sqrt(2/fan_in)."""
    fan_in = w[0].numel()
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
    """Initialise a Conv2d/Linear weight by ``kind`` (he_normal | xavier |
    normal) and zero its bias, on the CPU generator, in place."""
    if kind == "he_normal":
        he_normal_(m.weight, gen)
    elif kind == "xavier":
        xavier_uniform_(m.weight, gen)
    elif kind == "normal":
        normal_(m.weight, std, gen)
    else:
        raise ValueError(f"unknown init {kind!r}")
    if m.bias is not None:
        m.bias.zero_()
