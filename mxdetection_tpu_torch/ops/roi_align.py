"""Multilevel RoIAlign over an FPN pyramid — port of ``mxdetection_tpu.ops.roi_align``.

``multilevel_roi_align`` calls the registered operator ``mxdet::roi_align``
(``ops/library.py``), which dispatches on the device of its inputs: CPU
tensors take ``multilevel_roi_align_plain`` (the flat-buffer gather of the
JAX reference), differentiated by torch autograd of it; CUDA tensors take
the hand-written kernel K1, with K3 (and the bf16 convert K3b as its
epilogue) as its backward, in ``ops/cuda/roi_align.py``; any other device
raises. The FPN level of each roi is computed here, once, by
``fpn_level_assign``, and handed to either path, so the two never disagree
about a roi that sits on a level boundary.

Semantics are torchvision/Detectron2 ``aligned=False`` RoIAlign: each of the
P x P bins averages ``sampling_ratio**2`` bilinear samples; samples within
[-1, size] are clamped to the edge, samples beyond it contribute zero.
"""

from __future__ import annotations

from typing import Sequence

import torch


def fpn_level_assign(rois: torch.Tensor, *, min_level: int, max_level: int,
                     canonical_scale: float = 224.0,
                     canonical_level: int = 4) -> torch.Tensor:
    """FPN paper eq. (1): k = floor(k0 + log2(sqrt(w*h)/224)), clamped.

    rois: (..., 4) xyxy in image coordinates -> (...,) int32 level ids.
    """
    w = (rois[..., 2] - rois[..., 0]).clamp(min=1e-6)
    h = (rois[..., 3] - rois[..., 1]).clamp(min=1e-6)
    k = torch.floor(canonical_level + torch.log2(torch.sqrt(w * h) / canonical_scale))
    return k.clamp(min_level, max_level).to(torch.int32)


def roi_levels(rois: torch.Tensor, num_levels: int, *, min_level: int,
               canonical_scale: float, canonical_level: int) -> torch.Tensor:
    """Level index in [0, num_levels) of each roi (B, R, 4) -> (B, R) int32."""
    if num_levels == 1:
        return torch.zeros(rois.shape[:-1], dtype=torch.int32, device=rois.device)
    return fpn_level_assign(
        rois, min_level=min_level, max_level=min_level + num_levels - 1,
        canonical_scale=canonical_scale, canonical_level=canonical_level) - min_level


def roi_sample_taps(rois: torch.Tensor, levels: torch.Tensor,
                    sizes: Sequence[tuple[int, int]], strides: Sequence[int], *,
                    output_size: int = 7, sampling_ratio: int = 2) -> tuple:
    """The bilinear taps of every sample of every roi on its level.

    rois (B, R, 4) xyxy image coords; levels (B, R) int32 in [0, L); sizes
    the (H_l, W_l) of each level -> (y_lo, y_hi, wy_lo, wy_hi, x_lo, x_hi,
    wx_lo, wx_hi), each (B, R, P * S): sample k of an axis lies in bin
    k // S. Taps are int64 cell indices; weights float32, 0 for a sample
    beyond [-1, size] (its taps are clamped to the map all the same).
    """
    dev = rois.device
    lv = levels.long()
    h_arr = torch.tensor([h for h, _ in sizes], dtype=torch.int64, device=dev)[lv]
    w_arr = torch.tensor([w for _, w in sizes], dtype=torch.int64, device=dev)[lv]
    stride_arr = torch.tensor([float(s) for s in strides], dtype=torch.float32, device=dev)[lv]

    rois = rois.float()
    scale = 1.0 / stride_arr
    x1 = rois[..., 0] * scale
    y1 = rois[..., 1] * scale
    roi_w = (rois[..., 2] * scale - x1).clamp(min=1.0)
    roi_h = (rois[..., 3] * scale - y1).clamp(min=1.0)

    p, s = output_size, sampling_ratio
    # Divide by device tensors, not Python numbers: CUDA torch turns division
    # by a host scalar into multiplication by its reciprocal, which moves the
    # sample points by an ulp against the kernel's (and JAX's) true division.
    p_t = torch.tensor(float(p), device=dev)
    s_t = torch.tensor(float(s), device=dev)
    bin_w = roi_w / p_t
    bin_h = roi_h / p_t
    # point j within bin i: start + (i + (j + .5)/s) * bin
    ij = torch.arange(p, dtype=torch.float32, device=dev)[:, None]
    jj = (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s_t
    frac = (ij + jj).reshape(-1)  # (p*s,)
    ys = y1[..., None] + frac * bin_h[..., None]  # (B, R, p*s)
    xs = x1[..., None] + frac * bin_w[..., None]

    def weights(coord, size):
        size_f = size.float()[..., None]
        inside = (coord >= -1.0) & (coord <= size_f)
        cc = torch.minimum(coord.clamp(min=0.0), size_f - 1.0)
        lo = torch.floor(cc)
        hi = torch.minimum(lo + 1.0, size_f - 1.0)
        hi_w = cc - lo
        lo_w = 1.0 - hi_w
        zero = torch.zeros_like(lo_w)
        return (lo.long(), hi.long(), torch.where(inside, lo_w, zero),
                torch.where(inside, hi_w, zero))

    return weights(ys, h_arr) + weights(xs, w_arr)


def multilevel_roi_align_plain(features: Sequence[torch.Tensor], rois: torch.Tensor,
                               strides: Sequence[int], levels: torch.Tensor, *,
                               output_size: int = 7, sampling_ratio: int = 2,
                               roi_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch RoIAlign: the reference the CUDA kernel is held against.

    features: per level (B, H_l, W_l, C), finest first; rois (B, R, 4) xyxy
    image coords; levels (B, R) int32 in [0, L) -> (B, R, P, P, C) in the
    feature dtype. Samples are gathered from one flat (B * sum HW, C) buffer
    and accumulated in float32.
    """
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    dev = rois.device

    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)  # (B, sum HW, C)
    total = flat.shape[1]
    flat = flat.reshape(b * total, c)
    sizes = [(f.shape[1], f.shape[2]) for f in features]
    offsets = [0]
    for (fh, fw) in sizes[:-1]:
        offsets.append(offsets[-1] + fh * fw)
    lv = levels.long()
    w_arr = torch.tensor([s[1] for s in sizes], dtype=torch.int64, device=dev)[lv]
    off_arr = torch.tensor(offsets, dtype=torch.int64, device=dev)[lv]
    off_arr = off_arr + torch.arange(b, device=dev)[:, None] * total  # image offset

    p, s = output_size, sampling_ratio
    y_lo, y_hi, wy_lo, wy_hi, x_lo, x_hi, wx_lo, wx_hi = roi_sample_taps(
        rois, levels, sizes, strides, output_size=p, sampling_ratio=s)
    base = off_arr[..., None, None]
    wrow = w_arr[..., None, None]

    def gather(yi, xi):  # (B, R, p*s) x (B, R, p*s) -> (B, R, p*s, p*s, C) f32
        idx = base + yi[..., :, None] * wrow + xi[..., None, :]
        return flat[idx].float()

    val = (gather(y_lo, x_lo) * (wy_lo[..., :, None] * wx_lo[..., None, :])[..., None]
           + gather(y_lo, x_hi) * (wy_lo[..., :, None] * wx_hi[..., None, :])[..., None]
           + gather(y_hi, x_lo) * (wy_hi[..., :, None] * wx_lo[..., None, :])[..., None]
           + gather(y_hi, x_hi) * (wy_hi[..., :, None] * wx_hi[..., None, :])[..., None])
    out = val.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))
    if roi_valid is not None:
        out = torch.where(roi_valid[..., None, None, None], out, torch.zeros_like(out))
    return out.to(dtype)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], *, output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int = 2,
                         canonical_scale: float = 224.0, canonical_level: int = 4,
                         roi_valid: torch.Tensor | None = None) -> torch.Tensor:
    """RoIAlign over an FPN pyramid, batched over images.

    features: per level (B, H_l, W_l, C), finest first; rois (B, R, 4) xyxy
    in image coords (padded rows allowed, masked by ``roi_valid`` (B, R)).
    Returns (B, R, output_size, output_size, C) in the feature dtype.
    """
    levels = roi_levels(rois, len(features), min_level=min_level,
                        canonical_scale=canonical_scale, canonical_level=canonical_level)
    if rois.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"multilevel_roi_align: no implementation for device {rois.device}")
    from . import library

    if roi_valid is None:
        roi_valid = torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device)
    return library.roi_align(list(features), rois, levels, roi_valid, list(strides),
                             output_size, sampling_ratio)
