"""Batched pairwise IoU, dispatched on device.

The port's counterpart of ``mxdetection_tpu/ops/pallas/iou.py``: CPU
tensors take ``ops/boxes.py::pairwise_iou`` (the plain version), CUDA
tensors take the hand-written kernel of ``ops/cuda/iou.py``; any other
device raises. The two agree bit for bit, so the assigner's decisions do
not depend on the device.
"""

from __future__ import annotations

import torch

from .boxes import pairwise_iou


def pairwise_iou_batched(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """boxes1 (B, N, 4), boxes2 (B, G, 4) f32 -> IoU (B, N, G) f32."""
    if boxes1.device.type == "cpu":
        return pairwise_iou(boxes1, boxes2)
    if boxes1.device.type == "cuda":
        from .cuda.iou import pairwise_iou_cuda

        return pairwise_iou_cuda(boxes1, boxes2)
    raise RuntimeError(f"pairwise_iou_batched: no implementation for device {boxes1.device}")
