"""Deformable convolution v1 — port of ``mxdetection_tpu.ops.dcn``.

``deform_conv2d_batched`` calls the registered operator
``mxdet::deform_conv2d`` (``ops/library.py``), whose forward and backward
(``deform_conv2d_backward``) dispatch on the device of the input: CPU
tensors take the plain versions below, CUDA tensors the hand-written
kernels through ``ops/cuda/deform_conv.py``, any other device raises.

- Forward: ``deform_conv2d``, the plain version (the JAX package's gather
  formulation, batched: a bilinear gather of the k*k taps into patch rows,
  then one product with the weight), or the implicit-GEMM kernel
  ``csrc/deform_conv.cu`` (K5 at stride 1, K5b at stride 2).
- Backward, in the order of the JAX ``custom_vjp``
  (``mxdetection_tpu/ops/pallas/dcn.py:553-587``), whose residuals are only
  (x, offsets, weight), so nothing 9x the activation size is kept between
  forward and backward:
  1. dpatch = g @ W^T (``torch.matmul``, x's dtype, f32 accumulation);
  2. (dW, doffsets) = ``deform_wgrad_doffsets``: the patches rebuilt, dW =
     patches^T @ g with f32 accumulation, and the offset gradient reduced
     over channels. On the card one fused kernel (K6/K6b) does all three:
     the patch values never leave shared memory. The plain version builds
     the patches (``deform_patches_doffsets``) and multiplies them.
  3. dx = ``deform_col2im`` (K7/K7b on the card: dpatch scattered back to
     the input with the bilinear weights).
  Step 1 and the product of step 2 are the two products the JAX package
  leaves to XLA outside its kernels.

The JAX package's environment switch between its gather, shift and Pallas
paths, and its shift-select formulation, are TPU measures and are not
ported.

Layouts are the JAX package's: x (B, H, W, Cin) NHWC; offsets
(B, Ho, Wo, 2*k*k) in (dy, dx) order per tap, taps row-major; weight
(k, k, Cin, Cout) HWIO. Each of a sample's four bilinear corners
contributes zero when it lies outside the map, in value and in derivative.
The patches are rounded to the weight's dtype before the product, which
accumulates in float32, and the result is cast to x's dtype. The gradient
convention is autodiff's of the gather: ly = sy - floor(sy) with the floor
contributing nothing, so at an integer sample position the derivative is
one-sided, v(y0 + 1) - v(y0).

Offsets are exact by default. ``radius`` clamps them to [-radius, radius]
first, with the clip's gradient (zero outside the interval): the documented
deviation of the Pallas kernels (R = 3), used only to compare with them.
"""

from __future__ import annotations

import torch


def _corners(shape: tuple, offsets: torch.Tensor, *, kernel: int, stride: int, dilation: int,
             radius: float | None):
    """The sample points of deformable im2col on a (B, H, W) map: returns
    ly, lx (B, Ho, Wo, k, k) and, for the corners (y0, x0), (y0, x0 + 1),
    (y0 + 1, x0), (y0 + 1, x0 + 1) in that order, the row of each in the
    flattened (B * H * W, C) map (clamped into the map) and whether it lies
    in the map.

    The f32 operations and their order are those of the JAX gather path:
    sy = (i*stride + ty*dilation - pad) + dy, y0 = floor(sy), ly = sy - y0.
    """
    b, h, w = shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    k = kernel
    pad = dilation * (k - 1) // 2
    dev = offsets.device
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
    img = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)
    corners = []
    for yi, xi in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        rows = img + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        corners.append((rows, inb.float()))
    return sy - y0, sx - x0, corners


def _bilinear_weights(ly: torch.Tensor, lx: torch.Tensor) -> tuple:
    return (1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx


def deform_sample_patches(x: torch.Tensor, offsets: torch.Tensor, *, kernel: int = 3,
                          stride: int = 1, dilation: int = 1,
                          radius: float | None = None) -> torch.Tensor:
    """Deformable im2col: x (B, H, W, C), offsets (B, Ho, Wo, 2*k*k) ->
    (B, Ho, Wo, k*k*C) float32 patch rows (tap-major, then channel): the
    corner weights (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx masked to zero
    out of bounds, and the four corner products summed in that order."""
    b, h, w, c = x.shape
    ly, lx, corners = _corners((b, h, w), offsets, kernel=kernel, stride=stride,
                               dilation=dilation, radius=radius)
    flat = x.reshape(b * h * w, c)
    acc = None
    for (rows, inb), wgt in zip(corners, _bilinear_weights(ly, lx)):
        vals = flat[rows].float() * (wgt * inb)[..., None]  # (B, Ho, Wo, k, k, C)
        acc = vals if acc is None else acc + vals
    return acc.reshape(*acc.shape[:3], -1)


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


def offset_grad_terms(x: torch.Tensor, offsets: torch.Tensor, dpatch: torch.Tensor, *,
                      stride: int = 1, dilation: int = 1, radius: float | None = None) -> tuple:
    """x (B, H, W, C), offsets (B, Ho, Wo, 18), dpatch (B, Ho, Wo, 9C) ->
    the f32 patches (B, Ho, Wo, 3, 3, C) and, of the same shape, each
    channel's terms dpatch * ((1-lx)(v10-v00) + lx(v11-v01)) of doy and
    dpatch * ((1-ly)(v01-v00) + ly(v11-v10)) of dox, with v the corner
    values, zero outside the map; the offset gradient before the clip is
    their sum over channels."""
    k = 3
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    ly, lx, corners = _corners((b, h, w), offsets, kernel=k, stride=stride,
                               dilation=dilation, radius=radius)
    flat = x.reshape(b * h * w, c)
    v00, v01, v10, v11 = (flat[rows].float() * inb[..., None] for rows, inb in corners)
    w00, w01, w10, w11 = (wgt[..., None] for wgt in _bilinear_weights(ly, lx))
    patches = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    dp = dpatch.float().reshape(b, ho, wo, k, k, c)
    ly, lx = ly[..., None], lx[..., None]
    return (patches, dp * ((1 - lx) * (v10 - v00) + lx * (v11 - v01)),
            dp * ((1 - ly) * (v01 - v00) + ly * (v11 - v10)))


def clip_offset_grad(doff: torch.Tensor, offsets: torch.Tensor,
                     radius: float | None) -> torch.Tensor:
    """The clip's gradient: ``doff`` zeroed where ``radius`` clamps the
    offset (outside [-radius, radius]); unchanged without a radius."""
    if radius is None:
        return doff
    off = offsets.float().reshape(doff.shape)
    return doff * ((off >= -radius) & (off <= radius))


def deform_patches_doffsets(x: torch.Tensor, offsets: torch.Tensor, dpatch: torch.Tensor, *,
                            stride: int = 1, dilation: int = 1,
                            radius: float | None = None) -> tuple:
    """x (B, H, W, C), offsets (B, Ho, Wo, 18), dpatch (B, Ho, Wo, 9C), the
    gradient of the patch rows ->

    - patches (B, Ho, Wo, 9C) in x's dtype, the forward's rounded patch rows;
    - doffsets (B, Ho, Wo, 18) float32: per tap
      doy = sum_c dpatch * ((1-lx)(v10-v00) + lx(v11-v01)) and
      dox = sum_c dpatch * ((1-ly)(v01-v00) + ly(v11-v10)), with v the corner
      values, zero outside the map; with ``radius``, zero where the offset
      lies outside [-radius, radius] (the clip's gradient).

    What the TPU kernel K6 computed; ``deform_wgrad_doffsets`` builds on it.
    """
    b, ho, wo = offsets.shape[:3]
    patches, terms_y, terms_x = offset_grad_terms(x, offsets, dpatch, stride=stride,
                                                  dilation=dilation, radius=radius)
    doff = clip_offset_grad(torch.stack([terms_y.sum(-1), terms_x.sum(-1)], -1), offsets, radius)
    return patches.to(x.dtype).reshape(b, ho, wo, -1), doff.reshape(b, ho, wo, 18)


def deform_col2im(dpatch: torch.Tensor, offsets: torch.Tensor, x_shape: tuple, *,
                  stride: int = 1, dilation: int = 1,
                  radius: float | None = None) -> torch.Tensor:
    """The plain version of K7/K7b: the transpose of the bilinear sampling.
    dpatch (B, Ho, Wo, 9C), offsets (B, Ho, Wo, 18) -> dx (B, H, W, C)
    float32 for x of ``x_shape``: each tap's dpatch row times each corner's
    masked weight, summed into that corner's pixel (``index_add_``)."""
    k = 3
    b, h, w, c = x_shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    ly, lx, corners = _corners((b, h, w), offsets, kernel=k, stride=stride,
                               dilation=dilation, radius=radius)
    dp = dpatch.float().reshape(b, ho, wo, k, k, c)
    dx = torch.zeros((b * h * w, c), dtype=torch.float32, device=dpatch.device)
    for (rows, inb), wgt in zip(corners, _bilinear_weights(ly, lx)):
        dx.index_add_(0, rows.reshape(-1), (dp * (wgt * inb)[..., None]).reshape(-1, c))
    return dx.reshape(b, h, w, c)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation and a float32 result."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return torch.ops.aten.mm.dtype(a, b, torch.float32)


def deform_wgrad_doffsets(x: torch.Tensor, offsets: torch.Tensor, dpatch: torch.Tensor,
                          g: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                          radius: float | None = None) -> tuple:
    """The plain version of K6/K6b, the fused weight gradient: x (B, H, W,
    C), offsets (B, Ho, Wo, 18), dpatch (B, Ho, Wo, 9C), g (B * Ho * Wo,
    Cout) in x's dtype, the output's gradient -> (dW (9C, Cout) float32 =
    patches^T @ g with the patches rounded to x's dtype and f32
    accumulation, doffsets (B, Ho, Wo, 18) float32 as
    ``deform_patches_doffsets``)."""
    patches, doff = deform_patches_doffsets(x, offsets, dpatch, stride=stride, dilation=dilation,
                                            radius=radius)
    n = g.shape[0]
    return _matmul_f32(patches.reshape(n, -1).t(), g), doff


def deform_conv2d_backward(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                           g: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                           radius: float | None = None) -> tuple:
    """The backward of the module docstring from the residuals (x, offsets,
    weight) and the output's gradient g (B, Ho, Wo, Cout) -> (dx, doffsets,
    dW) in x's, the offsets' and the weight's dtypes: the kernels for CUDA
    tensors, the plain versions on the CPU."""
    conf = dict(stride=stride, dilation=dilation, radius=radius)
    k, cin, cout = weight.shape[0], weight.shape[2], weight.shape[3]
    b, ho, wo = offsets.shape[:3]
    g2 = g.to(x.dtype).reshape(b * ho * wo, cout).contiguous()
    wmat = weight.to(x.dtype).reshape(k * k * cin, cout)
    dpatch = torch.matmul(g2, wmat.t()).reshape(b, ho, wo, k * k * cin)
    if x.device.type == "cuda":
        from .cuda.deform_conv import deform_col2im_cuda, deform_wgrad_doffsets_cuda

        dw, doff = deform_wgrad_doffsets_cuda(x, offsets, dpatch, g2, **conf)
        dx = deform_col2im_cuda(dpatch, offsets, x.shape, **conf)
    else:
        dw, doff = deform_wgrad_doffsets(x, offsets, dpatch, g2, **conf)
        dx = deform_col2im(dpatch, offsets, x.shape, **conf)
    return (dx.to(x.dtype), doff.to(offsets.dtype),
            dw.reshape(k, k, cin, cout).to(weight.dtype))


def deform_conv2d_batched(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                          stride: int = 1, dilation: int = 1,
                          radius: float | None = None) -> torch.Tensor:
    """Deformable conv over a batch, differentiable in x, offsets and
    weight: the registered operator ``mxdet::deform_conv2d``
    (``ops/library.py``), the kernels for CUDA tensors, the plain versions
    on the CPU. Saves only (x, offsets, weight) for the backward
    (``deform_conv2d_backward``): the patches are rebuilt there, as the JAX
    ``custom_vjp`` and the CPU path's ``jax.checkpoint`` do."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"deform_conv2d_batched: no implementation for device {x.device}")
    from . import library

    return library.deform_conv(x, offsets, weight, stride, dilation,
                               None if radius is None else float(radius))
