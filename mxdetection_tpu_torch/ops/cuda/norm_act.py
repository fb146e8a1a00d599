"""Wrapper of the CUDA FrozenBN epilogue kernels (``csrc/norm_act.cu``).

They replace no TPU kernel (XLA fuses the affine into the convolutions
there). Reached through the operator ``mxdet::frozen_bn_act`` and its
registered backward (``ops/library.py``); the plain versions are
``ops/norm_act.py::frozen_bn_act_plain`` and
``frozen_bn_act_backward_plain``, which the kernels equal bit for bit.
"""

from __future__ import annotations

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("norm_act")
bwd_launch_count = LaunchCount("norm_act_bwd")

_DTYPES = (torch.float32, torch.bfloat16)


def _check(what: str, maps: list, channels: list) -> None:
    """``maps``: (B, C, H, W) tensors in channels_last memory, of one shape,
    dtype and CUDA device; ``channels``: contiguous (C,) tensors of that
    dtype and device; C a multiple of 8 and every pointer 16-byte aligned,
    or raise."""
    x = maps[0]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x.device}, expected a CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {_DTYPES}")
    if x.dim() != 4 or x.shape[1] % 8:
        raise ValueError(f"{what}: {tuple(x.shape)}, expected (B, C, H, W) with C a multiple "
                         "of 8")
    c = x.shape[1]
    for t in maps:
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"{what}: every map must be a channels_last {tuple(x.shape)} "
                             f"{x.dtype} tensor on {x.device}")
    for t in channels:
        if t.shape != (c,) or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: scales and biases must be contiguous ({c},) {x.dtype} "
                             f"tensors on {x.device}")
    if any(t.data_ptr() % 16 for t in (*maps, *channels)):
        raise ValueError(f"{what}: every tensor must start on a 16-byte boundary")


def frozen_bn_act_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       residual: torch.Tensor | None = None,
                       res_scale: torch.Tensor | None = None,
                       res_bias: torch.Tensor | None = None) -> torch.Tensor:
    """relu(x * scale + bias [+ residual, or + residual * res_scale +
    res_bias]) in one launch: x and residual (B, C, H, W) channels_last, the
    scales and biases (C,), all of one dtype (f32 or bf16) -> y like x."""
    mode = 0 if residual is None else 1 if res_scale is None else 2
    maps = [x] + ([residual] if mode else [])
    chans = [scale, bias] + ([res_scale, res_bias] if mode == 2 else [])
    _check("frozen_bn_act_cuda", maps, chans)
    y = torch.empty_like(x)
    r = residual if mode else x
    rs, rb = (res_scale, res_bias) if mode == 2 else (scale, bias)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().mxdet_norm_act_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), r.data_ptr(), rs.data_ptr(),
            rb.data_ptr(), y.data_ptr(), x.numel(), x.shape[1], int(x.dtype == torch.bfloat16),
            mode, stream)
    check(err, "mxdet_norm_act_fwd")
    launch_count.add()
    return y


def frozen_bn_act_bwd_cuda(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                           res_scale: torch.Tensor | None,
                           mode: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The gradients of ``frozen_bn_act_cuda`` from g and its output y (both
    like x) in one launch: (dx, the residual's gradient: None for mode 0
    (no residual), g masked by the ReLU for mode 1 (the residual as it is),
    that times ``res_scale`` for mode 2)."""
    _check("frozen_bn_act_bwd_cuda", [g, y], [scale] + ([res_scale] if mode == 2 else []))
    dx = torch.empty_like(g)
    dr = torch.empty_like(g) if mode else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = load_library().mxdet_norm_act_bwd(
            g.data_ptr(), y.data_ptr(), scale.data_ptr(),
            (res_scale if mode == 2 else scale).data_ptr(), dx.data_ptr(),
            (dr if mode else dx).data_ptr(), g.numel(), g.shape[1],
            int(g.dtype == torch.bfloat16), mode, stream)
    check(err, "mxdet_norm_act_bwd")
    bwd_launch_count.add()
    return dx, dr
