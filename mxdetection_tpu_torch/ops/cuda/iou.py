"""Wrapper of the CUDA max-IoU assigner (``csrc/iou.cu``).

Counterpart of ``mxdetection_tpu/ops/pallas/iou.py::_iou_kernel`` (K4)
fused with its consumers: the IoU matrix is reduced where it is computed
and never reaches memory. Reached from ``ops/matching.py::assign_max_iou``
and ``max_iou_rows`` for CUDA tensors; their plain version is the dense
``assign_max_iou_dense`` (and the row max of ``masked_iou``), which they
match bit for bit.
"""

from __future__ import annotations

import torch

from .build import LaunchCount, check, load_library

launch_count = LaunchCount("iou")
# the launches of each pass: A, the row max or the gt's best (every call
# makes one), and B, the low-quality force and the labels
pass_a_count = LaunchCount("iou_pass_a")
pass_b_count = LaunchCount("iou_pass_b")

MAX_COLS = 1024  # gt boxes of an image the kernel's shared memory holds

ROW_MAX, GT_BEST, LABELS, LABELS_FORCED = 0, 1, 2, 3  # the kernel's modes


def _boxes(boxes: torch.Tensor) -> tuple[torch.Tensor, int]:
    """-> (boxes, batch stride in floats): an anchor set expanded over the
    batch (stride 0) is read in place; anything else is made contiguous and
    16-byte aligned."""
    if boxes.stride(0) == 0 and boxes[0].is_contiguous() and boxes.data_ptr() % 16 == 0:
        return boxes, 0
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    return boxes, boxes.shape[1] * 4


def _check(what: str, boxes, gt_boxes, gt_valid, box_valid=None) -> None:
    if boxes.dim() != 3 or gt_boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or gt_boxes.shape[-1] != 4 or boxes.shape[0] != gt_boxes.shape[0] \
            or tuple(gt_valid.shape) != tuple(gt_boxes.shape[:2]) \
            or (box_valid is not None and tuple(box_valid.shape) != tuple(boxes.shape[:2])):
        raise ValueError(f"{what}: boxes {tuple(boxes.shape)}, gt_boxes "
                         f"{tuple(gt_boxes.shape)}, gt_valid {tuple(gt_valid.shape)}, "
                         f"box_valid {None if box_valid is None else tuple(box_valid.shape)}")
    if boxes.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"{what}: f32 boxes only, got {boxes.dtype}, {gt_boxes.dtype}")
    if not 1 <= gt_boxes.shape[1] <= MAX_COLS:
        raise ValueError(f"{what}: G={gt_boxes.shape[1]} outside [1, {MAX_COLS}]")
    dev = boxes.device
    for t in (gt_boxes, gt_valid, box_valid):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: every tensor must be on {dev}, got {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: boxes on {dev}, expected a CUDA device")


def _launch(mode: int, boxes, gt_boxes, gt_valid, box_valid=None, gt_best=None,
            thr=(0.0, 0.0, 0.0)) -> tuple:
    """One launch of the kernel in ``mode`` -> the (max_iou, matched,
    labels) it writes, None for those it does not."""
    b, n, g = boxes.shape[0], boxes.shape[1], gt_boxes.shape[1]
    dev = boxes.device
    boxes, stride1 = _boxes(boxes)
    gt_boxes = gt_boxes.contiguous()
    if gt_boxes.data_ptr() % 16:
        gt_boxes = gt_boxes.clone()
    gt_valid = gt_valid.to(torch.bool).contiguous()
    if box_valid is not None:
        box_valid = box_valid.to(torch.bool).contiguous()
    new = lambda dtype: torch.empty((b, n), dtype=dtype, device=dev)  # noqa: E731
    max_iou, matched, labels = ((None, None, None) if mode == GT_BEST else
                                (new(torch.float32), new(torch.int64),
                                 None if mode == ROW_MAX else new(torch.int32)))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_max_iou(boxes.data_ptr(), stride1, gt_boxes.data_ptr(),
                                gt_valid.data_ptr(), ptr(box_valid), b, n, g, mode, *thr,
                                ptr(gt_best), ptr(max_iou), ptr(matched), ptr(labels), stream)
    check(err, "mxdet_max_iou")
    launch_count.add()
    (pass_b_count if mode == LABELS_FORCED else pass_a_count).add()
    return max_iou, matched, labels


def max_iou_rows_cuda(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes (B, N, 4), gt_boxes (B, G, 4) f32, gt_valid (B, G) -> (max IoU
    of each box over the valid gt, -1 where an image has none; the first gt
    reaching it, int64), each (B, N): one launch of pass A."""
    _check("max_iou_rows_cuda", boxes, gt_boxes, gt_valid)
    max_iou, matched, _ = _launch(ROW_MAX, boxes, gt_boxes, gt_valid)
    return max_iou, matched


def assign_max_iou_cuda(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        *, pos_iou_thr: float, neg_iou_thr: float, min_pos_iou: float = 0.0,
                        match_low_quality: bool = True,
                        box_valid: torch.Tensor | None = None) -> tuple:
    """The max-IoU assigner's rule (``ops/matching.py::assign_max_iou``) ->
    (matched (B, N) int64, labels (B, N) int32, max_iou (B, N) f32 >= 0).
    With ``match_low_quality`` pass A folds each valid gt's best IoU into a
    (B, G) buffer and pass B recomputes the IoUs to force the boxes tying
    it; without, one pass labels the boxes."""
    _check("assign_max_iou_cuda", boxes, gt_boxes, gt_valid, box_valid)
    thr = (float(pos_iou_thr), float(neg_iou_thr), float(min_pos_iou))
    if not match_low_quality:
        max_iou, matched, labels = _launch(LABELS, boxes, gt_boxes, gt_valid, box_valid, thr=thr)
        return matched, labels, max_iou
    gt_best = torch.zeros(gt_boxes.shape[:2], dtype=torch.int32, device=boxes.device)
    _launch(GT_BEST, boxes, gt_boxes, gt_valid, gt_best=gt_best)
    max_iou, matched, labels = _launch(LABELS_FORCED, boxes, gt_boxes, gt_valid, box_valid,
                                       gt_best=gt_best, thr=thr)
    return matched, labels, max_iou
