"""Wrapper of the CUDA greedy-NMS kernels (``csrc/nms.cu``).

Counterpart of ``mxdetection_tpu/ops/pallas/nms.py::_nms_kernel`` (K2).
Reached from ``ops/nms.py::nms_mask_sorted`` for CUDA tensors; its plain
version is ``nms_mask_sorted_plain`` in the same module. The kernels' own
layout of the mask scratch is known only to ``csrc/nms.cu``, which reports
its size (``mxdet_nms_scratch_words``).
"""

from __future__ import annotations

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("nms")


def nms_mask_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_thr: float) -> torch.Tensor:
    """boxes (P, N, 4) SCORE-SORTED per problem, valid (P, N) -> keep (P, N)
    bool: the exact greedy keep mask of every problem, one launch for all."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_mask_sorted_cuda: boxes {tuple(boxes.shape)}, "
                         f"valid {tuple(valid.shape)}")
    dev = boxes.device
    if valid.device != dev:
        raise ValueError(f"nms_mask_sorted_cuda: valid on {valid.device}, expected {dev}")
    p, n = boxes.shape[:2]
    if n > 64 * 6144:  # removed-set of ceil(N/64) words must fit 48 KB of shared memory
        raise ValueError(f"nms_mask_sorted_cuda: N={n} too large")
    if dev.type != "cuda":
        raise ValueError(f"nms_mask_sorted_cuda: boxes on {dev}, expected a CUDA device")
    boxes = boxes.float().contiguous()
    valid = valid.to(torch.bool).contiguous()
    lib = load_library()
    # the suppression bitmask's scratch, in the kernel's own layout
    mask = torch.empty(lib.mxdet_nms_scratch_words(p, n), dtype=torch.int64, device=dev)
    keep = torch.empty((p, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_nms_mask_sorted(boxes.data_ptr(), valid.data_ptr(), p, n,
                                        float(iou_thr), mask.data_ptr(), keep.data_ptr(),
                                        stream)
    check(err, "mxdet_nms_mask_sorted")
    launch_count.add()
    return keep
