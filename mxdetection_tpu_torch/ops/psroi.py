"""Position-sensitive RoI pooling (PSRoIPool) and its deformable variant —
port of the gather form of ``mxdetection_tpu.ops.psroi.psroi_pool``
(``impl="gather"``), batched over images.

Bin (i, j) of the p x p output reads only its channel group ``(i*p + j)*c
.. (i*p + j + 1)*c`` of the score map. It averages s x s aligned bilinear
samples (RoIAlign's convention: a sample outside ``[-1, size]`` counts
zero, the others clamp to the map), optionally shifted by a per-bin offset
scaled by ``trans_std * (roi_h, roi_w)`` (DeformablePSROIPooling). Every
(image, roi, bin, sample, corner) is one row of a single ``index_select``
into the map viewed as (B*H*W*p*p, c): no relayout, and the bin's channel
group is part of the row index. The gradient is autograd's (an
``index_add_`` into the map, and through the bilinear weights into the
offsets). Plain PyTorch on every device: the JAX package has no Pallas
kernel here, only XLA. Its ``impl="dense"`` form exists for XLA:TPU's
scatter-adds and is not ported.
"""

from __future__ import annotations

import torch


def _taps(coord: torch.Tensor, size: int) -> tuple:
    """Bilinear taps along one axis: (lo, hi) int64 indices and their
    weights, zero outside [-1, size], the coordinate clamped to the map."""
    inside = (coord >= -1.0) & (coord <= float(size))
    cc = coord.clamp(0.0, size - 1.0)
    lo = torch.floor(cc)
    hi = torch.clamp(lo + 1.0, max=size - 1.0)
    hi_w = cc - lo
    lo_w = 1.0 - hi_w
    return (lo.long(), hi.long(), torch.where(inside, lo_w, 0.0),
            torch.where(inside, hi_w, 0.0))


def psroi_pool(feature: torch.Tensor, rois: torch.Tensor, stride: int, *,
               output_size: int = 7, sampling_ratio: int = 2,
               offsets: torch.Tensor | None = None, trans_std: float = 0.1,
               roi_valid: torch.Tensor | None = None) -> torch.Tensor:
    """feature (B, H, W, p*p*c) NHWC, channel ``(i*p + j)*c + k`` of bin
    (i, j); rois (B, R, 4) xyxy in image coordinates; ``stride`` the map's
    (spatial scale 1/stride); offsets (B, R, p, p, 2) normalised per-bin
    (dy, dx) or None for the plain pool; roi_valid (B, R), invalid rows
    zeroed. -> (B, R, p, p, c) in the feature's dtype, the samples
    averaged in f32."""
    b, h, w, c_full = feature.shape
    p, s = output_size, sampling_ratio
    if c_full % (p * p):
        raise ValueError(f"feature channels {c_full} not divisible by output_size^2 {p * p}")
    c = c_full // (p * p)
    dtype, dev = feature.dtype, feature.device
    rows = feature.reshape(b * h * w * p * p, c)

    scale = 1.0 / float(stride)
    rois = rois.float()
    x1, y1 = rois[..., 0] * scale, rois[..., 1] * scale
    roi_w = torch.clamp(rois[..., 2] * scale - x1, min=1.0)  # (B, R)
    roi_h = torch.clamp(rois[..., 3] * scale - y1, min=1.0)
    bin_w, bin_h = roi_w / p, roi_h / p

    # each (bin, sample)'s position in bin units: (p * s,)
    frac = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s)
    frac = frac.reshape(-1)
    r = rois.shape[1]
    shape = (b, r, p, p, s, s)  # (image, roi, bin row, bin col, sample y, sample x)
    ys = (y1[..., None] + frac * bin_h[..., None]).reshape(b, r, p, 1, s, 1).expand(shape)
    xs = (x1[..., None] + frac * bin_w[..., None]).reshape(b, r, 1, p, 1, s).expand(shape)
    if offsets is not None:
        dy = offsets[..., 0].float() * trans_std * roi_h[..., None, None]
        dx = offsets[..., 1].float() * trans_std * roi_w[..., None, None]
        ys = ys + dy[..., None, None]
        xs = xs + dx[..., None, None]

    y_lo, y_hi, wy_lo, wy_hi = _taps(ys, h)
    x_lo, x_hi, wx_lo, wx_hi = _taps(xs, w)
    group = torch.arange(p * p, device=dev).reshape(p, p)[:, :, None, None]
    base = torch.arange(b, device=dev).reshape(b, 1, 1, 1, 1, 1) * (h * w)

    def corner(yi, xi, wgt):
        idx = ((base + yi * w + xi) * (p * p) + group).reshape(-1)
        return rows.index_select(0, idx).reshape(*shape, c) * wgt[..., None].to(dtype)

    val = (corner(y_lo, x_lo, wy_lo * wx_lo) + corner(y_lo, x_hi, wy_lo * wx_hi)
           + corner(y_hi, x_lo, wy_hi * wx_lo) + corner(y_hi, x_hi, wy_hi * wx_hi))
    out = val.float().mean((4, 5))  # (B, R, p, p, c)
    if roi_valid is not None:
        out = torch.where(roi_valid[..., None, None, None], out, 0.0)
    return out.to(dtype)
