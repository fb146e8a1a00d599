"""Wrapper of the CUDA pairwise-IoU kernel (``csrc/iou.cu``).

Counterpart of ``mxdetection_tpu/ops/pallas/iou.py::_iou_kernel`` (K4).
Reached from ``ops/iou.py::pairwise_iou_batched`` for CUDA tensors; its
plain version is ``ops/boxes.py::pairwise_iou``.
"""

from __future__ import annotations

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("iou")

MAX_COLS = 2048  # boxes2 rows staged in the kernel's shared memory


def pairwise_iou_cuda(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """boxes1 (B, N, 4), boxes2 (B, G, 4) f32 -> (B, N, G) f32, one launch
    for all images. A boxes1 expanded over the batch (stride 0) is read in
    place, so a shared anchor set is not copied per image."""
    if boxes1.dim() != 3 or boxes2.dim() != 3 or boxes1.shape[-1] != 4 or boxes2.shape[-1] != 4 \
            or boxes1.shape[0] != boxes2.shape[0]:
        raise ValueError(f"pairwise_iou_cuda: boxes1 {tuple(boxes1.shape)}, "
                         f"boxes2 {tuple(boxes2.shape)}")
    if boxes1.dtype != torch.float32 or boxes2.dtype != torch.float32:
        raise TypeError(f"pairwise_iou_cuda: f32 boxes only, got {boxes1.dtype}, {boxes2.dtype}")
    b, n, g = boxes1.shape[0], boxes1.shape[1], boxes2.shape[1]
    if g > MAX_COLS:
        raise ValueError(f"pairwise_iou_cuda: G={g} > {MAX_COLS}")
    dev = boxes1.device
    if boxes2.device != dev:
        raise ValueError(f"pairwise_iou_cuda: boxes2 on {boxes2.device}, expected {dev}")
    if dev.type != "cuda":
        raise ValueError(f"pairwise_iou_cuda: boxes on {dev}, expected a CUDA device")
    if boxes1.stride(0) == 0 and boxes1[0].is_contiguous():
        stride1 = 0
    else:
        boxes1 = boxes1.contiguous()
        stride1 = n * 4
    boxes2 = boxes2.contiguous()
    out = torch.empty((b, n, g), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_pairwise_iou(boxes1.data_ptr(), stride1, boxes2.data_ptr(), b, n, g,
                                     out.data_ptr(), stream)
    check(err, "mxdet_pairwise_iou")
    launch_count.add()
    return out
