"""Detector registry — port of ``mxdetection_tpu.models.registry``: every
detector of the zoo, inference and training. ``cfg.detector`` picks the
module (``build_detector``) and its loss and postprocess
(``detector_fns``, the JAX ``DetectorBundle``'s ``loss_fn`` and
``postprocess``): Faster R-CNN (frozen BN or SyncBN), Mask R-CNN and
Cascade R-CNN with deformable convs (``RCNN``), R-FCN (``RFCN``; the R-CNN
loss and postprocess) and RetinaNet (``RetinaNet``; its focal loss and
dense postprocess). Every detector takes ``forward_test(images, im_info)``
and ``forward_train(tb, draws)``."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import Config


class DetectorFns(NamedTuple):
    loss: Callable         # (forward_train's outputs, tb, draws, cfg) -> (loss, metrics)
    postprocess: Callable  # (forward_test's outputs, cfg, image_hw, im_info) -> detections


def detector_fns(cfg: Config) -> DetectorFns:
    """``cfg.detector`` -> its loss and postprocess."""
    if cfg.detector == "retinanet":
        from .detectors.retinanet import retinanet_loss, retinanet_postprocess

        return DetectorFns(retinanet_loss, retinanet_postprocess)
    if cfg.detector in ("faster_rcnn", "mask_rcnn", "cascade_rcnn", "rfcn"):
        from .detectors.rcnn import rcnn_loss, rcnn_postprocess

        return DetectorFns(rcnn_loss, rcnn_postprocess)
    raise ValueError(f"unknown detector {cfg.detector!r}")


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
    from .backbones.resnet import DeformConv
    from .detectors.rcnn import RCNN, RCNN_DETECTORS
    from .detectors.retinanet import RetinaNet
    from .detectors.rfcn import RFCN
    from .layers import NORMS

    classes = {**dict.fromkeys(RCNN_DETECTORS, RCNN), "retinanet": RetinaNet, "rfcn": RFCN}
    if cfg.detector not in classes:
        raise ValueError(f"unknown detector {cfg.detector!r}")
    device = require_device(device)
    model = classes[cfg.detector](cfg)
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
