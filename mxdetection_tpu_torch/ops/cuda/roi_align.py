"""Wrapper of the CUDA RoIAlign forward kernel (``csrc/roi_align.cu``).

Counterpart of ``mxdetection_tpu/ops/pallas/roi_align.py::_kernel`` (K1).
Reached from ``ops/roi_align.py::multilevel_roi_align`` for CUDA tensors; its
plain version is ``multilevel_roi_align_plain`` in the same module.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("roi_align")

_DTYPES = (torch.float32, torch.bfloat16)


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
    if rois.shape != (b, r, 4) or levels.shape != (b, r) or roi_valid.shape != (b, r):
        raise ValueError(f"roi_align_cuda: rois {tuple(rois.shape)}, levels "
                         f"{tuple(levels.shape)}, roi_valid {tuple(roi_valid.shape)}")
    if levels.device != dev or roi_valid.device != dev:
        raise ValueError(f"roi_align_cuda: levels and roi_valid must be on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"roi_align_cuda: tensors on {dev}, expected a CUDA device")
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    roi_valid = roi_valid.to(torch.bool).contiguous()

    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=dev)
    n = len(features)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * n)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * n)(*[f.shape[2] for f in features])
    scales = (ctypes.c_float * n)(*[1.0 / float(s) for s in strides])
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
