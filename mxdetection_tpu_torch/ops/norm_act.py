"""FrozenBN's per-channel affine with the ReLU and the residual add that
follow it, as one operator, ``mxdet::frozen_bn_act`` (``ops/library.py``).

    y = relu(x * scale + bias [+ residual])
    residual: the block's input as it is, or the downsample conv's raw
              output through its own BN, residual * res_scale + res_bias

On the card one pass of ``csrc/norm_act.cu`` (forward and backward), on the
CPU the plain versions below, which are the eager op sequence of the
modules (``models/layers.py::FrozenBatchNorm``, ``F.relu``, ``+``): every
product and sum rounded to the activation's dtype where that sequence
rounds, so the kernel, the plain version and the unfused modules give the
same bits, forward and backward. The scales and biases are the
activation's dtype (``FrozenBatchNorm.affine``); they are frozen and get no
gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import count

_SHAPE = (1, -1, 1, 1)


def frozen_bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor | None = None,
                        res_scale: torch.Tensor | None = None,
                        res_bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, C, H, W), scale and bias (C,) in x's dtype -> y like x."""
    y = x * scale.view(_SHAPE) + bias.view(_SHAPE)
    if residual is not None:
        if res_scale is not None:
            residual = residual * res_scale.view(_SHAPE) + res_bias.view(_SHAPE)
        y = y + residual
    return F.relu(y)


def frozen_bn_act_backward_plain(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                                 res_scale: torch.Tensor | None,
                                 mode: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The gradients of ``frozen_bn_act_plain`` from g and its output y, as
    autograd of it computes them: (dx, the residual's gradient, None without
    a residual; ``mode`` 0: none, 1: the residual as it is, 2: through
    ``res_scale``)."""
    gm = torch.ops.aten.threshold_backward(g, y, 0)
    dres = None if mode == 0 else gm if mode == 1 else gm * res_scale.view(_SHAPE)
    return gm * scale.view(_SHAPE), dres


def frozen_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None, res_scale: torch.Tensor | None = None,
                  res_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The operator ``mxdet::frozen_bn_act``: the kernel for CUDA tensors
    (channels_last, f32 or bf16, C a multiple of 8, else it raises), the
    plain version on the CPU; differentiable in x and the residual. Counts
    ``norm_act.fused`` under the innermost open span
    (``utils/profiling.py``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"frozen_bn_act: no implementation for device {x.device}")
    from . import library

    count("norm_act.fused")
    return library.frozen_bn_act(x, scale, bias, residual, res_scale, res_bias)
