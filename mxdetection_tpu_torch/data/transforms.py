"""Fused image transform: resize + pad + normalize + flip — port of
``mxdetection_tpu.data.transforms``.

The host ships a fixed-size zero-padded uint8 canvas (raw_h, raw_w) plus the
true (h, w); the device computes the per-image scale and resamples to a
fixed (pad_h, pad_w) output. The resample is ``jax.image.scale_and_translate``
with ``method="linear"``, ported as two separable weight-matrix contractions
per image (``scale_translate_weights``, computed exactly as jax's
``compute_weight_mat``: a triangle kernel widened by 1/scale when
downsampling, i.e. antialiased, with normalised columns). ``F.interpolate``
does not antialias this way and would not match.
"""

from __future__ import annotations

import torch

from ..ops import boxes as box_lib

_F32_EPS = float(torch.finfo(torch.float32).eps)


def scale_translate_weights(input_size: int, output_size: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """(B,) scale/translation -> (B, input_size, output_size) f32 linear
    (triangle) resampling weights with antialiasing."""
    dev = scale.device
    inv_scale = (torch.ones_like(scale) / scale)[:, None, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_idx = torch.arange(output_size, dtype=torch.float32, device=dev)
    in_idx = torch.arange(input_size, dtype=torch.float32, device=dev)
    sample_f = ((out_idx[None, None, :] + 0.5) * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)  # (B, 1, out)
    x = (sample_f - in_idx[None, :, None]).abs() / kernel_scale
    weights = (1.0 - x.abs()).clamp(min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    # zero the weights where the sample lies wholly outside the input
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def fused_image_transform(raw: torch.Tensor, hw: torch.Tensor, flip: torch.Tensor, *,
                          out_hw: tuple[int, int], scale_size, max_size: int,
                          mean: tuple, std: tuple,
                          dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """raw (B, raw_h, raw_w, 3) uint8, hw (B, 2) true (h, w), flip (B,) bool,
    scale_size (B,) short-side targets -> (images (B, out_h, out_w, 3), scale (B,)).

    scale = min(scale_size / short, max_size / long, canvas fit); the resized
    content occupies the top-left (h*scale, w*scale) region and the rest is
    zero after normalisation. A flip mirrors the canvas and folds the shift
    into the resample's translation, as the JAX transform does.
    """
    dev = raw.device
    b, raw_h, raw_w, _ = raw.shape
    out_h, out_w = out_hw
    h, w = hw[:, 0].float(), hw[:, 1].float()
    # true divisions of tensors: torch computes `number / tensor` through a
    # reciprocal, an ulp off jax's division, and the resample amplifies an ulp
    full = lambda v: torch.full_like(h, float(v))
    scale = torch.minimum(scale_size / torch.minimum(h, w), full(max_size) / torch.maximum(h, w))
    scale = torch.minimum(scale, torch.minimum(full(out_h) / h, full(out_w) / w))  # canvas fit

    new_h, new_w = h * scale, w * scale
    raw_in = torch.where(flip[:, None, None, None], raw.flip(2), raw).float()
    tx = torch.where(flip, torch.round(new_w) - scale * raw_w, torch.zeros_like(scale))
    wy = scale_translate_weights(raw_h, out_h, scale, torch.zeros_like(scale))
    wx = scale_translate_weights(raw_w, out_w, scale, tx)
    out = torch.einsum("bhwc,bhH->bHwc", raw_in, wy)
    out = torch.einsum("bHwc,bwW->bHWc", out, wx)

    yy = torch.arange(out_h, dtype=torch.float32, device=dev)
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)
    valid = (yy[None, :, None] < new_h[:, None, None]) & (xx[None, None, :] < new_w[:, None, None])
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    out = torch.where(valid[..., None], (out - mean_t) / std_t, torch.zeros_like(out))
    return out.to(dtype), scale


def transform_gt(boxes: torch.Tensor, scale: torch.Tensor, flip: torch.Tensor,
                 new_w: torch.Tensor) -> torch.Tensor:
    """Scale (B, G, 4) gt boxes into network coordinates, honoring the flip."""
    b = boxes * scale[:, None, None]
    return torch.where(flip[:, None, None], box_lib.flip_boxes(b, new_w[:, None]), b)


def batch_transform(raw: torch.Tensor, hw: torch.Tensor, flip: torch.Tensor,
                    gt_boxes: torch.Tensor, *, out_hw: tuple[int, int], scale_size: int,
                    max_size: int, mean: tuple, std: tuple, dtype=torch.bfloat16) -> dict:
    """Fused per-batch transform -> dict(images, gt_boxes, im_info).

    im_info rows are (orig_h, orig_w, scale). The JAX version's per-image
    ``scale_sizes`` (multi-scale training) comes with the training slice.
    """
    scale_sizes = torch.full(raw.shape[:1], float(scale_size), device=raw.device)
    imgs, scale = fused_image_transform(
        raw, hw, flip, out_hw=out_hw, scale_size=scale_sizes, max_size=max_size,
        mean=mean, std=std, dtype=dtype)
    gtb = transform_gt(gt_boxes, scale, flip, hw[:, 1].float() * scale)
    info = torch.stack([hw[:, 0].float(), hw[:, 1].float(), scale], dim=1)
    return {"images": imgs, "gt_boxes": gtb, "im_info": info}
