"""Detector registry — port of ``mxdetection_tpu.models.registry`` for the
detectors ported so far (Faster R-CNN inference)."""

from __future__ import annotations

import torch

from ..config import Config


def build_detector(cfg: Config, device="cpu", seed: int | None = None) -> torch.nn.Module:
    """``cfg.detector`` -> an eval-mode detector on ``device``, in the config's
    compute dtype, channels-last. With ``seed`` the weights get the JAX
    package's initialisers from a ``torch.Generator`` (the card has no JAX
    to convert weights from); otherwise load a converted ``state_dict``
    (``utils/convert.py``)."""
    if cfg.detector != "faster_rcnn":
        raise NotImplementedError(f"detector {cfg.detector!r} is not ported yet "
                                  "(ROADMAP Queue 1 items 11-14)")
    from .detectors.rcnn import RCNN

    model = RCNN(cfg)
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    dtype = getattr(torch, cfg.backbone.dtype)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    for p in model.parameters():  # FrozenBN statistics stay f32 buffers, as in JAX
        p.data = p.data.to(dtype)
    return model
