"""Convert JAX/flax detector variables into the port's ``state_dict``.

Input: the ``{"params": ..., "batch_stats": ...}`` tree of
``mxdetection_tpu`` as nested dicts of numpy arrays (``jax.device_get`` of
the variables gives that). The port names its modules after the flax module
tree, so a variable at ``params/backbone/layer1_block0/conv1/kernel`` lands
at ``backbone.layer1_block0.conv1.weight``; RetinaNet's ``fpn/extra_p6``,
``fpn/extra_p7`` and ``head/cls_conv{i}``, ``reg_conv{i}``, ``cls_score``,
``bbox_pred``, and R-FCN's ``rpn``, ``conv_new``, ``rfcn_cls``,
``rfcn_bbox`` and ``rfcn_offset`` take the same rules:

- conv kernels HWIO -> OIHW;
- a transposed conv's kernel (flax ``ConvTranspose``, (kh, kw, in, out),
  the mask head's ``mask_deconv``) -> ``ConvTranspose2d``'s (in, out, kh,
  kw) with both spatial axes flipped: flax's ``transpose_kernel=False``
  convolves the dilated input with the kernel as it is, torch's transposed
  conv with the kernel flipped. The shape cannot tell it from a conv kernel
  (in = out = 256 in the mask head), so the rule is chosen by the module
  that receives it: ``flax_to_state_dict`` needs the model for such a tree;
- Dense kernels (in, out) -> Linear weights (out, in). The RoI features reach
  ``bbox_head0/fc1`` flattened channels-last, (7, 7, 256) in HWC order, in
  both frameworks, so its rows need no permutation;
- FrozenBN ``gamma/beta/mean/var`` (``batch_stats``) -> buffers of the same
  names;
- SyncBN ``gamma/beta`` (``params``, rank 1) -> its parameters of the same
  names, and its ``mean/var`` (``batch_stats``) -> its buffers;
- GroupNorm's ``GroupNorm_0/scale`` and ``GroupNorm_0/bias`` (the flax
  module inside the JAX wrapper) -> the port's ``gamma`` and ``beta``.

The flax train-mode and eval-mode detectors share one variable tree, so the
same conversion loads a training model (``build_detector(train=True)``,
f32 master weights) and an eval model (weights cast to its compute dtype).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def flax_to_state_dict(variables: dict, model: torch.nn.Module | None = None) -> dict:
    """-> {name: float32 tensor} for ``model.load_state_dict``. A 4-D kernel
    goes to a conv unless ``model`` holds a transposed conv at its name;
    without ``model`` a tree with a transposed conv's kernel would convert
    wrongly, so ``load_flax_variables`` always passes it."""
    transposed = set() if model is None else {
        name for name, m in model.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)}
    sd = {}
    for name, arr in _flatten(variables.get("params", {})).items():
        prefix, leaf = name.rpartition(".")[::2]
        head, _, last = prefix.rpartition(".")
        if last == "GroupNorm_0" and leaf in ("scale", "bias"):
            prefix, leaf = head, {"scale": "gamma", "bias": "beta"}[leaf]
        prefix = prefix + "." if prefix else ""
        if leaf in ("gamma", "beta") and arr.ndim == 1:
            sd[prefix + leaf] = arr
        elif leaf == "kernel" and arr.ndim == 4 and prefix[:-1] in transposed:
            sd[prefix + "weight"] = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "kernel" and arr.ndim == 4:
            sd[prefix + "weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:
            sd[prefix + "weight"] = arr.T
        elif leaf == "bias":
            sd[prefix + "bias"] = arr
        else:
            raise ValueError(f"unexpected parameter {name} {arr.shape}")
    sd.update(_flatten(variables.get("batch_stats", {})))
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32) for k, v in sd.items()}


def load_flax_variables(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load converted flax variables into ``model`` in place (strict: every
    tensor of the model must be covered, and nothing left over)."""
    sd = flax_to_state_dict(variables, model)
    ref = model.state_dict()
    sd = {k: v.to(dtype=ref[k].dtype) if k in ref else v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
