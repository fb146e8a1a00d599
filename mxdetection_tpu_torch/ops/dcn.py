"""Deformable convolution v1 — port of ``mxdetection_tpu.ops.dcn``.

``deform_conv2d_batched`` dispatches on the device of its input: a CPU
tensor takes ``deform_conv2d`` below, the plain version (the JAX package's
gather formulation, batched: a bilinear gather of the k*k taps into patch
rows, then one product with the weight); a CUDA tensor takes the
hand-written implicit-GEMM kernel ``csrc/deform_conv.cu`` (K5 at stride 1,
K5b at stride 2) through ``ops/cuda/deform_conv.py``; any other device
raises. The JAX package's environment switch between its gather, shift and
Pallas paths, and its shift-select formulation, are TPU measures and are
not ported.

Layouts are the JAX package's: x (B, H, W, Cin) NHWC; offsets
(B, Ho, Wo, 2*k*k) in (dy, dx) order per tap, taps row-major; weight
(k, k, Cin, Cout) HWIO. Each of a sample's four bilinear corners
contributes zero when it lies outside the map. The patches are rounded to
the weight's dtype before the product, which accumulates in float32, and
the result is cast to x's dtype.

Offsets are exact by default. ``radius`` clamps them to [-radius, radius]
first: the documented deviation of the Pallas kernels (R = 3), used only to
compare with them.
"""

from __future__ import annotations

import torch


def deform_sample_patches(x: torch.Tensor, offsets: torch.Tensor, *, kernel: int = 3,
                          stride: int = 1, dilation: int = 1,
                          radius: float | None = None) -> torch.Tensor:
    """Deformable im2col: x (B, H, W, C), offsets (B, Ho, Wo, 2*k*k) ->
    (B, Ho, Wo, k*k*C) float32 patch rows (tap-major, then channel).

    The f32 operations and their order are those of the JAX gather path:
    sy = (i*stride + ty*dilation - pad) + dy, y0 = floor(sy), ly = sy - y0,
    corner weights (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx masked to zero
    out of bounds, and the four corner products summed in that order.
    """
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    k = kernel
    pad = dilation * (k - 1) // 2
    dev = x.device
    off = offsets.float().reshape(b, ho, wo, k, k, 2)
    if radius is not None:
        off = off.clamp(-radius, radius)

    out_y = torch.arange(ho, dtype=torch.float32, device=dev) * stride
    out_x = torch.arange(wo, dtype=torch.float32, device=dev) * stride
    tap = torch.arange(k, dtype=torch.float32, device=dev) * dilation - pad
    base_y = out_y[:, None, None, None] + tap[None, None, :, None]  # (Ho, 1, k, 1)
    base_x = out_x[None, :, None, None] + tap[None, None, None, :]  # (1, Wo, 1, k)
    sy = base_y + off[..., 0]  # (B, Ho, Wo, k, k)
    sx = base_x + off[..., 1]

    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly = sy - y0
    lx = sx - x0
    flat = x.reshape(b * h * w, c)
    img = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)

    def tap_vals(yi, xi, wgt):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        vals = flat[img + yc * w + xc].float()  # (B, Ho, Wo, k, k, C)
        return vals * (wgt * inb.float())[..., None]

    acc = (tap_vals(y0, x0, (1 - ly) * (1 - lx))
           + tap_vals(y0, x0 + 1, (1 - ly) * lx)
           + tap_vals(y0 + 1, x0, ly * (1 - lx))
           + tap_vals(y0 + 1, x0 + 1, ly * lx))
    return acc.reshape(b, ho, wo, k * k * c)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                  stride: int = 1, dilation: int = 1,
                  radius: float | None = None) -> torch.Tensor:
    """The plain version: x (B, H, W, Cin), offsets (B, Ho, Wo, 2*k*k),
    weight (k, k, Cin, Cout) -> (B, Ho, Wo, Cout) in x's dtype. The patches
    are rounded to the weight's dtype and multiplied in float32, so every
    product is exact and the sum is f32, as ``preferred_element_type``."""
    k, cin, cout = weight.shape[0], weight.shape[2], weight.shape[3]
    patches = deform_sample_patches(x, offsets, kernel=k, stride=stride, dilation=dilation,
                                    radius=radius)
    wmat = weight.reshape(k * k * cin, cout)
    out = torch.matmul(patches.to(wmat.dtype).float(), wmat.float())
    return out.to(x.dtype)


def deform_conv2d_batched(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                          stride: int = 1, dilation: int = 1,
                          radius: float | None = None) -> torch.Tensor:
    """Deformable conv over a batch: the kernel for CUDA tensors (inference
    only: its backward is not ported yet), the plain version on the CPU."""
    if x.device.type == "cpu":
        return deform_conv2d(x, offsets, weight, stride=stride, dilation=dilation,
                             radius=radius)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or offsets.requires_grad
                                        or weight.requires_grad):
            raise NotImplementedError("the deformable conv's backward kernels (K6, K7) are "
                                      "not ported yet (ROADMAP Queue 1 item 13b)")
        from .cuda.deform_conv import deform_conv2d_cuda

        return deform_conv2d_cuda(x, offsets, weight, stride=stride, dilation=dilation,
                                  radius=radius)
    raise RuntimeError(f"deform_conv2d_batched: no implementation for device {x.device}")
