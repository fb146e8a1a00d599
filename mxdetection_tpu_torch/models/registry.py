"""Detector registry — port of ``mxdetection_tpu.models.registry`` for the
detectors ported so far: Faster R-CNN (frozen BN or SyncBN), Mask R-CNN
and Cascade R-CNN with deformable convs, inference and training."""

from __future__ import annotations

import torch

from ..config import Config


def require_device(device) -> torch.device:
    """The device a user asked for; a CUDA device must exist (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device='cpu' to run its plain versions on the CPU")
    return device


def build_detector(cfg: Config, device="cuda", seed: int | None = None,
                   train: bool = False) -> torch.nn.Module:
    """``cfg.detector`` -> a detector on ``device`` (the card unless the
    caller asks for the CPU), channels-last, computing in the config's dtype.

    ``train=False``: an eval-mode model whose parameters are stored in the
    compute dtype, but for the deformable convs' offset convs, which stay
    f32 as the JAX layer's (sample positions depend on them), and the
    norms' ``gamma``/``beta``, which stay f32 as the JAX layers form the
    scale in f32 and cast only the result.
    ``train=True``: a train-mode model whose parameters all stay f32 master
    weights, cast to the compute dtype where they are read, as flax's
    ``param_dtype=float32, dtype=bfloat16`` (the offset convs compute in
    f32). With ``seed`` the
    weights get the JAX package's initialisers from a ``torch.Generator``
    (the card has no JAX to convert weights from); otherwise load a
    converted ``state_dict`` (``utils/convert.py``)."""
    if cfg.detector not in ("faster_rcnn", "mask_rcnn", "cascade_rcnn"):
        raise NotImplementedError(f"detector {cfg.detector!r} is not ported yet "
                                  "(ROADMAP Queue 1 items 12-14)")
    from .backbones.resnet import DeformConv
    from .detectors.rcnn import RCNN
    from .layers import NORMS

    device = require_device(device)
    model = RCNN(cfg)
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last).train(train)
    if not train:
        keep_f32 = {id(p) for m in model.modules()
                    for p in (m.offset_conv.parameters() if isinstance(m, DeformConv) else
                              m.parameters() if isinstance(m, NORMS) else ())}
        for p in model.parameters():  # norm statistics stay f32 buffers, as in JAX
            if id(p) not in keep_f32:
                p.data = p.data.to(model.compute_dtype)
    return model
