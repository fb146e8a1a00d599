"""Wrapper of the CUDA deformable-conv kernel (``csrc/deform_conv.cu``).

Counterpart of ``mxdetection_tpu/ops/pallas/dcn.py``: ``_kernel`` (K5,
``deform_conv2d_pallas_batched``, stride 1) and ``_kernel_s2`` (K5b,
``deform_conv2d_s2_pallas_batched``, stride 2), both the inference forward.
Reached from ``ops/dcn.py::deform_conv2d_batched`` for CUDA tensors; the
plain version is ``ops/dcn.py::deform_conv2d``. One kernel serves both
strides; each stride has its own launch counter.
"""

from __future__ import annotations

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("deform_conv")        # K5, stride 1
s2_launch_count = LaunchCount("deform_conv_s2")  # K5b, stride 2

_DTYPES = (torch.float32, torch.bfloat16)
TILE_K, TILE_N = 64, 64  # Cin is walked in chunks of TILE_K; Cout in tiles of TILE_N


def deform_conv2d_cuda(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                       stride: int = 1, dilation: int = 1,
                       radius: float | None = None) -> torch.Tensor:
    """x (B, H, W, Cin) contiguous, f32 or bf16; offsets (B, Ho, Wo, 18) f32,
    Ho = ceil(H / stride); weight (3, 3, Cin, Cout) HWIO in x's dtype ->
    (B, Ho, Wo, Cout) in x's dtype. ``radius`` clamps the offsets."""
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"deform_conv2d_cuda: x {x.dtype} and weight {weight.dtype} must be "
                        f"one dtype of {_DTYPES}")
    if offsets.dtype != torch.float32:
        raise TypeError(f"deform_conv2d_cuda: offsets must be float32, got {offsets.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[:2] != (3, 3):
        raise ValueError(f"deform_conv2d_cuda: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}; expected (B, H, W, Cin), (3, 3, Cin, Cout)")
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    if stride not in (1, 2) or dilation < 1:
        raise ValueError(f"deform_conv2d_cuda: stride {stride} (1 or 2), dilation {dilation}")
    ho, wo = -(-h // stride), -(-w // stride)
    if weight.shape[2] != cin or cin % TILE_K or cout % TILE_N:
        raise ValueError(f"deform_conv2d_cuda: Cin={cin}, Cout={cout}; the weight must take "
                         f"x's channels, Cin a multiple of {TILE_K} and Cout of {TILE_N}")
    if offsets.shape != (b, ho, wo, 18):
        raise ValueError(f"deform_conv2d_cuda: offsets {tuple(offsets.shape)}, expected "
                         f"{(b, ho, wo, 18)}")
    if not (x.is_contiguous() and offsets.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("deform_conv2d_cuda: x and offsets must be contiguous NHWC, x "
                         "16-byte aligned")
    dev = x.device
    if dev.type != "cuda" or offsets.device != dev or weight.device != dev:
        raise ValueError(f"deform_conv2d_cuda: x, offsets and weight on {dev}, "
                         f"{offsets.device}, {weight.device}; expected one CUDA device")
    wmat = weight.reshape(9 * cin, cout).contiguous()
    if wmat.data_ptr() % 16:
        wmat = wmat.clone()
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_deform_conv_fwd(
            x.data_ptr(), offsets.data_ptr(), wmat.data_ptr(), out.data_ptr(), b, h, w, cin,
            ho, wo, cout, stride, dilation, -1.0 if radius is None else float(radius),
            int(x.dtype == torch.bfloat16), stream)
    check(err, "mxdet_deform_conv_fwd")
    (launch_count if stride == 1 else s2_launch_count).add()
    return out
