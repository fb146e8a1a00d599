"""Load a torchvision-format ResNet checkpoint into the port's backbone —
port of ``mxdetection_tpu.utils.pretrained`` together with
``tools/convert_pretrained.py``'s name rules.

The port reads the user's ``.pth`` directly (``torch.load`` with
``weights_only=True``; no torchvision, nothing downloaded), so it needs no
conversion step: the backbone's modules already carry the JAX tree's names
(``stem_conv``, ``layer{s}_block{b}.conv{i}``, ``downsample_conv``) and its
FrozenBN ``gamma/beta/mean/var``. As in the JAX package, a backbone entry the
file lacks keeps its initialisation, a file key with no place in the
backbone raises, and the classifier head (``fc.``) and BN bookkeeping
(``num_batches_tracked``) are skipped.
"""

from __future__ import annotations

import torch

_SKIP_PREFIXES = ("fc.",)
_SKIP_SUFFIXES = ("num_batches_tracked",)
_BN = {"weight": "gamma", "bias": "beta", "running_mean": "mean", "running_var": "var"}


def torchvision_name(key: str) -> str:
    """A torchvision ResNet key -> the port's backbone name:
    ``conv1``/``bn1`` -> ``stem_conv``/``stem_bn``; ``layerS.B.convI`` /
    ``bnI`` -> ``layerS_blockB.convI`` / ``bnI``; ``downsample.0``/``.1`` ->
    ``downsample_conv``/``downsample_bn``; BN weight, bias, running_mean,
    running_var -> gamma, beta, mean, var."""
    parts = key.split(".")
    if parts[0] in ("conv1", "bn1"):
        mod, leaf = ["stem_conv" if parts[0] == "conv1" else "stem_bn"], parts[1:]
    elif parts[0].startswith("layer") and len(parts) >= 4:
        block = f"{parts[0]}_block{parts[1]}"
        if parts[2] == "downsample":
            mod = [block, {"0": "downsample_conv", "1": "downsample_bn"}.get(parts[3], parts[3])]
            leaf = parts[4:]
        else:
            mod, leaf = [block, parts[2]], parts[3:]
    else:
        return key
    is_bn = mod[-1].startswith("bn") or mod[-1].endswith("_bn")
    if is_bn and len(leaf) == 1:
        leaf = [_BN.get(leaf[0], leaf[0])]
    return ".".join(mod + leaf)


def load_backbone(model: torch.nn.Module, path: str) -> int:
    """Copy the ResNet weights of the torchvision checkpoint ``path`` into
    ``model.backbone`` (or ``model`` itself when it has no ``backbone``), in
    place, cast to each tensor's dtype and device. Returns the number of
    tensors loaded."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    backbone = getattr(model, "backbone", model)
    own = backbone.state_dict()
    n = 0
    with torch.no_grad():
        for key, value in sd.items():
            if key.startswith(_SKIP_PREFIXES) or key.endswith(_SKIP_SUFFIXES):
                continue
            name = torchvision_name(key)
            if name not in own:
                raise KeyError(f"{path}: {key!r} (as {name!r}) has no place in the backbone")
            if tuple(own[name].shape) != tuple(value.shape):
                raise ValueError(f"{path}: {key!r} has shape {tuple(value.shape)}, the "
                                 f"backbone's {name!r} {tuple(own[name].shape)}")
            own[name].copy_(value)
            n += 1
    if n == 0:
        raise ValueError(f"{path} contained no backbone tensors")
    return n
