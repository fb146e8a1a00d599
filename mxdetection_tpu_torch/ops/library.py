"""The port's inference kernels as registered operators, namespace ``mxdet``.

Each operator is defined with ``torch.library`` and has two
implementations and a shape function:

- ``mxdet::roi_align``: multilevel RoIAlign, K1 (``ops/cuda/roi_align.py``)
  on the card, ``ops/roi_align.py::multilevel_roi_align_plain`` on the CPU;
- ``mxdet::nms_mask_sorted``: the greedy keep mask of score-sorted
  problems, K2 (``ops/cuda/nms.py``) on the card,
  ``ops/nms.py::nms_mask_sorted_plain`` on the CPU;
- ``mxdet::deform_conv2d``: the deformable conv, K5 at stride 1 and K5b at
  stride 2 (``ops/cuda/deform_conv.py``) on the card,
  ``ops/dcn.py::deform_conv2d`` on the CPU;
- ``mxdet::frozen_bn_act``: FrozenBN's affine with its ReLU and residual
  add, ``csrc/norm_act.cu`` (``ops/cuda/norm_act.py``) on the card,
  ``ops/norm_act.py::frozen_bn_act_plain`` on the CPU.

The CUDA implementation launches the kernel (its wrapper counts the
launch) and the CPU one runs the plain version: which one runs is the
dispatcher's choice by the inputs' device, and no other device has one.
The shape functions (``register_fake``) let ``torch.export`` trace a
program down to the operator without running it, so an exported program
holds one node for each call, and a process that loads it needs this
module and nothing of the models (``tools/export.py``).

RoIAlign, the deformable conv and the FrozenBN epilogue carry their
gradients (``register_autograd``): on the card K3 (with K3b, the bf16
convert, as its epilogue) for RoIAlign, K6/K6b and K7/K7b for the deformable
conv and ``norm_act.cu``'s backward pass for the epilogue; on the CPU
autograd of RoIAlign's plain version, recomputed in the backward
(``torch.func.vjp``), and the other two's plain backwards. The
gradient reaches RoIAlign's features only: the rois, their levels and
``roi_valid`` get none, as in the JAX package's ``make_trainable_roi_align``.
The training-only kernels (K3, K4, K6, K7) are not operators of their own.

The operators are defined with ``torch.library.Library``, not
``torch.library.custom_op``: ``custom_op`` wraps each implementation so
that its first call imports ``torch._dynamo``, 8-10 s of start-up for every
process that calls an operator on an H100 host (torch 2.11). Importing this
module registers the operators; it builds no kernel.
"""

from __future__ import annotations

import torch

from .dcn import deform_conv2d, deform_conv2d_backward
from .nms import nms_mask_sorted_plain
from .norm_act import frozen_bn_act_backward_plain, frozen_bn_act_plain
from .roi_align import multilevel_roi_align_plain

_LIB = torch.library.Library("mxdet", "DEF")


def _define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define ``mxdet::<schema>`` with its CPU and CUDA implementations and
    its shape function; returns the operator."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"mxdet::{name}", fake, lib=_LIB)
    return getattr(torch.ops.mxdet, name).default


# ---------------------------------------------------------------- RoIAlign (K1, K3)


def _roi_align_cpu(features, rois, levels, roi_valid, strides, output_size, sampling_ratio):
    return multilevel_roi_align_plain(features, rois, strides, levels, output_size=output_size,
                                      sampling_ratio=sampling_ratio, roi_valid=roi_valid)


def _roi_align_cuda(features, rois, levels, roi_valid, strides, output_size, sampling_ratio):
    from .cuda.roi_align import roi_align_cuda

    return roi_align_cuda(features, rois, strides, levels, output_size=output_size,
                          sampling_ratio=sampling_ratio, roi_valid=roi_valid)


def _roi_align_fake(features, rois, levels, roi_valid, strides, output_size, sampling_ratio):
    b, r = rois.shape[:2]
    return features[0].new_empty((b, r, output_size, output_size, features[0].shape[-1]))


# features: per level (B, H_l, W_l, C), finest first; rois (B, R, 4) xyxy
# image coords; levels (B, R) int32 in [0, L); roi_valid (B, R) bool ->
# (B, R, P, P, C) in the feature dtype, zero where not roi_valid
roi_align = _define(
    "roi_align(Tensor[] features, Tensor rois, Tensor levels, Tensor roi_valid, int[] strides, "
    "int output_size, int sampling_ratio) -> Tensor", _roi_align_cpu, _roi_align_cuda,
    _roi_align_fake)


def _roi_align_setup(ctx, inputs, output):
    features, rois, levels, roi_valid, strides, output_size, sampling_ratio = inputs
    ctx.cuda = rois.device.type == "cuda"
    ctx.conf = (list(strides), output_size, sampling_ratio)
    ctx.shapes = [tuple(f.shape[1:3]) for f in features]
    ctx.dtype = features[0].dtype
    # K3 needs only the levels' shapes; the CPU recomputes the plain forward
    ctx.save_for_backward(rois, levels, roi_valid, *(() if ctx.cuda else features))


def _roi_align_backward(ctx, grad):
    rois, levels, roi_valid, *features = ctx.saved_tensors
    strides, output_size, sampling_ratio = ctx.conf
    if ctx.cuda:
        from .cuda.roi_align import roi_align_bwd_cuda

        grads = roi_align_bwd_cuda(grad, ctx.shapes, rois, strides, levels,
                                   sampling_ratio=sampling_ratio, roi_valid=roi_valid,
                                   out_dtype=ctx.dtype)
    else:
        _, vjp = torch.func.vjp(
            lambda *fs: multilevel_roi_align_plain(
                list(fs), rois, strides, levels, output_size=output_size,
                sampling_ratio=sampling_ratio, roi_valid=roi_valid), *features)
        grads = vjp(grad)
    return list(grads), None, None, None, None, None, None


torch.library.register_autograd("mxdet::roi_align", _roi_align_backward,
                                setup_context=_roi_align_setup, lib=_LIB)


# ---------------------------------------------------------------- greedy NMS (K2)


def _nms_mask_sorted_cuda(boxes, valid, iou_thr):
    from .cuda.nms import nms_mask_sorted_cuda

    return nms_mask_sorted_cuda(boxes, valid, iou_thr)


def _nms_mask_sorted_fake(boxes, valid, iou_thr):
    return valid.new_empty(boxes.shape[:2], dtype=torch.bool)


# boxes (P, N, 4) SCORE-SORTED per problem, valid (P, N) bool -> the exact
# greedy keep mask (P, N) bool of every problem
nms_mask_sorted = _define(
    "nms_mask_sorted(Tensor boxes, Tensor valid, float iou_thr) -> Tensor",
    nms_mask_sorted_plain, _nms_mask_sorted_cuda, _nms_mask_sorted_fake)


# ---------------------------------------------------------------- deformable conv (K5-K7b)


def _deform_conv_cpu(x, offsets, weight, stride, dilation, radius):
    return deform_conv2d(x, offsets, weight, stride=stride, dilation=dilation, radius=radius)


def _deform_conv_cuda(x, offsets, weight, stride, dilation, radius):
    from .cuda.deform_conv import deform_conv2d_cuda

    return deform_conv2d_cuda(x, offsets, weight, stride=stride, dilation=dilation,
                              radius=radius)


def _deform_conv_fake(x, offsets, weight, stride, dilation, radius):
    return x.new_empty((*offsets.shape[:3], weight.shape[3]))


# x (B, H, W, Cin), offsets (B, Ho, Wo, 18) float32, weight (3, 3, Cin,
# Cout) HWIO -> (B, Ho, Wo, Cout) in x's dtype; radius (None: exact
# offsets) clamps the offsets to [-radius, radius] first
deform_conv = _define(
    "deform_conv2d(Tensor x, Tensor offsets, Tensor weight, int stride, int dilation, "
    "float? radius) -> Tensor", _deform_conv_cpu, _deform_conv_cuda, _deform_conv_fake)


def _deform_conv_setup(ctx, inputs, output):
    x, offsets, weight, stride, dilation, radius = inputs
    ctx.conf = dict(stride=stride, dilation=dilation, radius=radius)
    ctx.save_for_backward(x, offsets, weight)


def _deform_conv_backward(ctx, g):
    x, offsets, weight = ctx.saved_tensors
    return (*deform_conv2d_backward(x, offsets, weight, g, **ctx.conf), None, None, None)


torch.library.register_autograd("mxdet::deform_conv2d", _deform_conv_backward,
                                setup_context=_deform_conv_setup, lib=_LIB)


# ---------------------------------------------------------------- FrozenBN epilogue


def _frozen_bn_act_cuda(x, scale, bias, residual, res_scale, res_bias):
    from .cuda.norm_act import frozen_bn_act_cuda

    return frozen_bn_act_cuda(x, scale, bias, residual, res_scale, res_bias)


def _frozen_bn_act_fake(x, scale, bias, residual, res_scale, res_bias):
    return torch.empty_like(x)  # x's shape, dtype and (channels_last) strides


# x (B, C, H, W), scale and bias (C,) in x's dtype; residual like x or None,
# through (residual_scale, residual_bias) when given -> relu(x * scale +
# bias [+ residual]) like x
frozen_bn_act = _define(
    "frozen_bn_act(Tensor x, Tensor scale, Tensor bias, Tensor? residual, "
    "Tensor? residual_scale, Tensor? residual_bias) -> Tensor",
    frozen_bn_act_plain, _frozen_bn_act_cuda, _frozen_bn_act_fake)


def _frozen_bn_act_setup(ctx, inputs, output):
    x, scale, bias, residual, res_scale, res_bias = inputs
    ctx.mode = 0 if residual is None else 1 if res_scale is None else 2
    ctx.save_for_backward(output, scale, res_scale)


def _frozen_bn_act_backward(ctx, g):
    y, scale, res_scale = ctx.saved_tensors
    if g.device.type == "cuda":
        from .cuda.norm_act import frozen_bn_act_bwd_cuda

        # the same values in the kernel's layout (a no-op for a conv's gradient)
        g = g.contiguous(memory_format=torch.channels_last)
        dx, dres = frozen_bn_act_bwd_cuda(g, y, scale, res_scale, ctx.mode)
    else:
        dx, dres = frozen_bn_act_backward_plain(g, y, scale, res_scale, ctx.mode)
    return dx, None, None, dres, None, None


torch.library.register_autograd("mxdet::frozen_bn_act", _frozen_bn_act_backward,
                                setup_context=_frozen_bn_act_setup, lib=_LIB)
