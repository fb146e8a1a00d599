"""Convert JAX/flax detector variables into the port's ``state_dict``.

Input: the ``{"params": ..., "batch_stats": ...}`` tree of
``mxdetection_tpu`` as nested dicts of numpy arrays (``jax.device_get`` of
the variables gives that). The port names its modules after the flax module
tree, so a variable at ``params/backbone/layer1_block0/conv1/kernel`` lands
at ``backbone.layer1_block0.conv1.weight``:

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in). The RoI features reach
  ``bbox_head0/fc1`` flattened channels-last, (7, 7, 256) in HWC order, in
  both frameworks, so its rows need no permutation;
- FrozenBN ``gamma/beta/mean/var`` (``batch_stats``) -> buffers of the same
  names.
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


def flax_to_state_dict(variables: dict) -> dict:
    """-> {name: float32 tensor} for ``model.load_state_dict``."""
    sd = {}
    for name, arr in _flatten(variables.get("params", {})).items():
        prefix, leaf = name.rpartition(".")[::2]
        prefix = prefix + "." if prefix else ""
        if leaf == "kernel" and arr.ndim == 4:
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
    sd = flax_to_state_dict(variables)
    ref = model.state_dict()
    sd = {k: v.to(dtype=ref[k].dtype) if k in ref else v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
