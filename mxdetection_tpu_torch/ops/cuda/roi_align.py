"""Wrappers of the CUDA RoIAlign kernels (``csrc/roi_align.cu``,
``csrc/roi_align_bwd.cu``).

Counterparts of ``mxdetection_tpu/ops/pallas/roi_align.py``: ``_kernel``
(K1, the forward), ``_bwd_kernel`` (K3, the backward) and ``kern`` in
``_convert_pallas`` (K3b, the f32 -> bf16 convert of K3's accumulators).
Reached from ``ops/roi_align.py::multilevel_roi_align`` for CUDA tensors
(the backward through its ``autograd.Function``); the plain versions are
``multilevel_roi_align_plain`` and torch autograd of it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("roi_align")
bwd_launch_count = LaunchCount("roi_align_bwd")
convert_launch_count = LaunchCount("f32_to_bf16")

_DTYPES = (torch.float32, torch.bfloat16)


def _level_arrays(shapes: Sequence[tuple[int, int]], strides: Sequence[int]):
    n = len(shapes)
    return (n, (ctypes.c_int * n)(*[h for h, _ in shapes]),
            (ctypes.c_int * n)(*[w for _, w in shapes]),
            (ctypes.c_float * n)(*[1.0 / float(s) for s in strides]))


def _check_rois(what, b, r, rois, levels, roi_valid, dev):
    if rois.shape != (b, r, 4) or levels.shape != (b, r) or roi_valid.shape != (b, r):
        raise ValueError(f"{what}: rois {tuple(rois.shape)}, levels "
                         f"{tuple(levels.shape)}, roi_valid {tuple(roi_valid.shape)}")
    if rois.device != dev or levels.device != dev or roi_valid.device != dev:
        raise ValueError(f"{what}: rois, levels and roi_valid must be on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}, expected a CUDA device")
    return (rois.float().contiguous(), levels.to(torch.int32).contiguous(),
            roi_valid.to(torch.bool).contiguous())


def roi_align_cuda(features: Sequence[torch.Tensor], rois: torch.Tensor,
                   strides: Sequence[int], levels: torch.Tensor, *,
                   output_size: int = 7, sampling_ratio: int = 2,
                   roi_valid: torch.Tensor | None = None) -> torch.Tensor:
    """features: per level (B, H_l, W_l, C) contiguous, f32 or bf16; rois
    (B, R, 4) f32; levels (B, R) int32 -> (B, R, P, P, C) in the feature dtype."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    dev = rois.device
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align_cuda: feature dtype {dtype} not in {_DTYPES}")
    if not 1 <= c <= 1024:
        raise ValueError(f"roi_align_cuda: C={c} outside [1, 1024]")
    if not 1 <= len(features) <= 5 or len(strides) != len(features):
        raise ValueError("roi_align_cuda: 1 to 5 levels, one stride each")
    if output_size * sampling_ratio > 64:
        raise ValueError("roi_align_cuda: output_size * sampling_ratio must be <= 64")
    for f in features:
        if (f.device != dev or f.dtype != dtype or f.dim() != 4 or f.shape[0] != b
                or f.shape[-1] != c or not f.is_contiguous()):
            raise ValueError("roi_align_cuda: every level must be a contiguous "
                             f"(B, H, W, C) {dtype} tensor on {dev}")
    if roi_valid is None:
        roi_valid = torch.ones((b, r), dtype=torch.bool, device=dev)
    rois, levels, roi_valid = _check_rois("roi_align_cuda", b, r, rois, levels, roi_valid, dev)

    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=dev)
    n, hs, ws, scales = _level_arrays([tuple(f.shape[1:3]) for f in features], strides)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_roi_align_fwd(
            ptrs, hs, ws, scales, n, rois.data_ptr(), levels.data_ptr(),
            roi_valid.data_ptr(), out.data_ptr(), b * r, r, c, output_size,
            sampling_ratio, int(dtype == torch.bfloat16), stream)
    check(err, "mxdet_roi_align_fwd")
    launch_count.add()
    return out


def f32_to_bf16_cuda(x: torch.Tensor) -> torch.Tensor:
    """K3b: a contiguous f32 CUDA tensor -> the same values in bf16 (round
    to nearest even, as ``x.to(torch.bfloat16)``)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"f32_to_bf16_cuda: needs a contiguous f32 tensor, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"f32_to_bf16_cuda: tensor on {x.device}, expected a CUDA device")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxdet_f32_to_bf16(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    check(err, "mxdet_f32_to_bf16")
    convert_launch_count.add()
    return out


def roi_align_bwd_cuda(grad_out: torch.Tensor, feature_shapes: Sequence[tuple[int, int]],
                       rois: torch.Tensor, strides: Sequence[int], levels: torch.Tensor, *,
                       sampling_ratio: int = 2, roi_valid: torch.Tensor | None = None,
                       out_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """K3 (+ K3b): grad_out (B, R, P, P, C) f32 or bf16, the (H_l, W_l) of
    each level, rois (B, R, 4), levels (B, R) -> the gradient of each level's
    features, (B, H_l, W_l, C) in ``out_dtype``. Sums are f32 atomics into
    one zeroed buffer for all levels; for bf16 one K3b launch converts it."""
    if grad_out.dim() != 5 or grad_out.shape[2] != grad_out.shape[3]:
        raise ValueError(f"roi_align_bwd_cuda: grad_out {tuple(grad_out.shape)}, "
                         "expected (B, R, P, P, C)")
    b, r, p, _, c = grad_out.shape
    dev = grad_out.device
    if grad_out.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd_cuda: dtypes {grad_out.dtype} -> {out_dtype} "
                        f"not in {_DTYPES}")
    if not 1 <= c <= 1024:
        raise ValueError(f"roi_align_bwd_cuda: C={c} outside [1, 1024]")
    if not 1 <= len(feature_shapes) <= 5 or len(strides) != len(feature_shapes):
        raise ValueError("roi_align_bwd_cuda: 1 to 5 levels, one stride each")
    if p * sampling_ratio > 64:
        raise ValueError("roi_align_bwd_cuda: output_size * sampling_ratio must be <= 64")
    if roi_valid is None:
        roi_valid = torch.ones((b, r), dtype=torch.bool, device=dev)
    rois, levels, roi_valid = _check_rois("roi_align_bwd_cuda", b, r, rois, levels,
                                          roi_valid, dev)
    grad_out = grad_out.contiguous()

    sizes = [b * h * w * c for h, w in feature_shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    n, hs, ws, scales = _level_arrays(feature_shapes, strides)
    ptrs = (ctypes.c_void_p * n)(*[v.data_ptr() for v in acc.split(sizes)])
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_roi_align_bwd(
            ptrs, hs, ws, scales, n, rois.data_ptr(), levels.data_ptr(),
            roi_valid.data_ptr(), grad_out.data_ptr(), b * r, r, c, p, sampling_ratio,
            int(grad_out.dtype == torch.bfloat16), stream)
    check(err, "mxdet_roi_align_bwd")
    bwd_launch_count.add()
    out = acc if out_dtype == torch.float32 else f32_to_bf16_cuda(acc)
    return [v.view(b, h, w, c) for v, (h, w) in zip(out.split(sizes), feature_shapes)]
