"""Export the whole inference program as a ``torch.export`` artifact, and
load one without the model code:

    python -m mxdetection_tpu_torch.tools.export --config faster_rcnn_r50_fpn_1x \
        --out faster_rcnn.pt2 [--checkpoint DIR] [--batch-size 1] [--raw-hw 640 640] \
        [--override k=v ...] [--device cpu]

Counterpart of the JAX ``tools/export.py``, the serving-deployment story:
the artifact holds the FULL inference program (the fused transform of uint8
canvases, the network, the decode and the class-aware NMS) with its
weights, at static shapes, for one device (``--device``, the card unless
the caller asks for the CPU), as a ``jax.export`` module is for one
platform. The kernels are the registered operators of ``ops/library.py``
(``mxdet::roi_align``, ``mxdet::nms_mask_sorted``,
``mxdet::deform_conv2d``, ``mxdet::frozen_bn_act``): the artifact calls
them by name, and
``load_serving`` needs that module and nothing of the models:

    from mxdetection_tpu_torch.tools.export import load_serving
    serve = load_serving("faster_rcnn.pt2")            # the device it was exported for
    boxes, scores, labels, valid = serve(raw, hw)      # raw (B, h, w, 3) uint8, hw (B, 2) f32

Without ``--checkpoint`` the weights are ``tools/common.py::seeded_model``'s
(the JAX tool's are its ``PRNGKey(0)`` init). No masks are served, as in
the JAX tool. Only this module's export functions import the models.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..ops import library  # noqa: F401  (registers the mxdet operators)


class ServingModule(torch.nn.Module):
    """``build_serving_fn`` of the JAX tool: raw (B, raw_h, raw_w, 3) uint8
    and hw (B, 2) float32 image sizes -> (boxes, scores, labels, valid) of
    the detector's fixed-size detections: ``tools/common.py::infer_batch``
    without masks (no flip, ``cfg.data``'s scale, max size, mean and std,
    the backbone's dtype)."""

    def __init__(self, model: torch.nn.Module, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, raw: torch.Tensor, hw: torch.Tensor) -> tuple:
        from .common import infer_batch

        dets, _ = infer_batch(self.model, self.cfg, raw, hw, self.model.compute_dtype,
                              masks=False)
        return dets["boxes"], dets["scores"], dets["labels"], dets["valid"]


def export_serving(model: torch.nn.Module, cfg, batch_size: int = 1,
                   raw_hw=(640, 640)) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``ServingModule(model, cfg)`` under
    ``torch.no_grad()`` for inputs of (batch_size, *raw_hw, 3) uint8 and
    (batch_size, 2) float32 on the model's device."""
    device = next(model.parameters()).device
    raw = torch.zeros((batch_size, *raw_hw, 3), dtype=torch.uint8, device=device)
    hw = torch.tensor([[float(raw_hw[0]), float(raw_hw[1])]] * batch_size, device=device)
    with torch.no_grad():
        return torch.export.export(ServingModule(model, cfg).eval(), (raw, hw))


def load_serving(path: str, device="cuda"):
    """Load an artifact of this tool -> a callable (raw, hw) -> (boxes,
    scores, labels, valid) that runs on ``device``, which must be the one
    it was exported for (the card unless the caller asks for the CPU).
    Imports the operators and nothing of the models."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: load_serving runs on the card by default; "
                           "pass device='cpu' for an artifact exported for the CPU")
    program = torch.export.load(path)
    # the weights' devices: the constants the forward builds on the host
    # (the anchors, the means) lie on the CPU and are copied in every call
    exported_for = {t.device.type for t in program.state_dict.values()}
    if exported_for != {device.type}:
        raise ValueError(f"{path} was exported for {sorted(exported_for)}, not {device.type}")
    module = program.module()
    return module.requires_grad_(False)  # serving records no autograd graph


def main(argv=None) -> int:
    from ..config import load_config
    from ..models.registry import require_device
    from ..train.checkpoint import CheckpointManager
    from .common import parse_overrides, seeded_model

    ap = argparse.ArgumentParser(description="Export a detector's inference program.")
    ap.add_argument("--config", required=True, help="zoo name or configs/<name>.py")
    ap.add_argument("--override", nargs="*", default=[], help="dotted.key=value ...")
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint", default=None, help="directory of tools.train's checkpoints")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--raw-hw", type=int, nargs=2, default=(640, 640))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.override))
    model = seeded_model(cfg, require_device(args.device))
    if args.checkpoint:
        CheckpointManager(args.checkpoint).load_model(model)
    b, (rh, rw) = args.batch_size, args.raw_hw
    t0 = time.perf_counter()
    program = export_serving(model, cfg, b, (rh, rw))
    torch.export.save(program, args.out)
    print(f"exported {os.path.getsize(args.out)} bytes to {args.out} in "
          f"{time.perf_counter() - t0:.1f} s (in: raw{b, rh, rw, 3} u8 + hw{b, 2} f32 -> "
          "boxes/scores/labels/valid)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
