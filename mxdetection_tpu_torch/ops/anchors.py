"""Anchor generation for the RPN — port of ``mxdetection_tpu.ops.anchors``.

Anchors are a function of static feature shapes only, computed in numpy and
returned as float32 tensors on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch


def base_anchors(stride: int, scales: tuple, ratios: tuple, *,
                 legacy_offset: float = 0.0) -> np.ndarray:
    """(len(scales)*len(ratios), 4) xyxy anchors centered on one cell.

    Ratio-major enumeration (the family convention); centered at stride/2,
    or at (stride-1)/2 with rounded legacy sizes when ``legacy_offset=1``.
    """
    anchors = []
    size = float(stride)
    if legacy_offset:
        ctr = (stride - 1.0) / 2.0
        for ratio in ratios:
            w0 = np.round(np.sqrt(size * size / ratio))
            h0 = np.round(w0 * ratio)
            for scale in scales:
                w, h = w0 * scale, h0 * scale
                anchors.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                                ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    else:
        ctr = stride / 2.0
        for ratio in ratios:
            w0 = np.sqrt(size * size / ratio)
            h0 = w0 * ratio
            for scale in scales:
                w, h = w0 * scale, h0 * scale
                anchors.append([ctr - 0.5 * w, ctr - 0.5 * h, ctr + 0.5 * w, ctr + 0.5 * h])
    return np.asarray(anchors, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, scales: tuple, ratios: tuple, *,
                 legacy_offset: float = 0.0, device=None) -> torch.Tensor:
    """All anchors for one feature level -> (feat_h * feat_w * A, 4).

    Row-major over (y, x, anchor): the order every dense head flattens its
    per-cell predictions into, so anchor i aligns with prediction i.
    """
    base = base_anchors(stride, scales, ratios, legacy_offset=legacy_offset)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)
    all_anchors = shifts[:, :, None, :] + base[None, None, :, :]
    return torch.from_numpy(np.ascontiguousarray(all_anchors.reshape(-1, 4))).to(device)


class AnchorGenerator:
    """Multi-level anchor generator for FPN pyramids (RPN: scales=(8,),
    ratios=(0.5, 1, 2), strides=(4, 8, 16, 32, 64) for P2..P6)."""

    def __init__(self, strides, scales, ratios, legacy_offset: float = 0.0):
        self.strides = tuple(strides)
        self.scales = tuple(scales)
        self.ratios = tuple(ratios)
        self.legacy_offset = legacy_offset

    @property
    def num_base_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    def per_level(self, feat_shapes, device=None) -> list:
        """feat_shapes: [(H_l, W_l)] per level -> [(H_l*W_l*A, 4)] per level."""
        return [
            grid_anchors(h, w, s, self.scales, self.ratios,
                         legacy_offset=self.legacy_offset, device=device)
            for (h, w), s in zip(feat_shapes, self.strides)
        ]
