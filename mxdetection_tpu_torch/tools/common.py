"""What the port's command-line tools share: ``--override`` parsing, the
process group a launcher describes and the device of a rank
(``process_group``), the dataset of a config (its COCO or VOC files, or a
synthetic set), the seeded model and the inference batch of the throughput
tools (``bench_infer``, ``bench_train``), which ``chip_smoke.py`` and the
``Evaluator`` run too, and the tools' launch counts.

The seeded model deviates from the JAX tools' ``bundle.init(PRNGKey(0))``
weights on purpose (the card's machine has no JAX to draw them):
``build_detector(cfg, seed=0)`` draws the JAX initialisers from a
``torch.Generator`` and gives each residual block's last FrozenBN gamma
1/sqrt(blocks), and ``seeded_model`` then scales RetinaNet's and R-FCN's
class conv (``CLASS_CONV_SCALE``). Without that scale their seeded scores
sit at the class prior, under the 0.05 test threshold: the postprocess
would have nothing to sort or suppress, and a bench would time an empty
NMS. Cascade R-CNN's offset convs, zero in the JAX init (every DCN a plain
conv, K5 sampling on the grid), get seeded noise from ``seed_offset_convs``
in the throughput tools, so that K5-K7 run at offsets of about one cell.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import sys

import torch
import torch.distributed as dist

from ..config import Config
from ..data.coco import CocoDataset, make_synthetic_coco
from ..data.transforms import batch_transform
from ..data.voc import VocDataset, make_synthetic_voc
from ..models.detectors.rcnn import mask_probs
from ..models.registry import build_detector, detector_fns, require_device
from ..parallel.dist import on_rank0
from ..parallel.mesh import initialize_from_env, local_device, world_size
from ..utils.profiling import annotate


def parse_overrides(pairs) -> dict:
    """``["a.b=1", "c=(1, 2)", "d=text"]`` -> {"a.b": 1, "c": (1, 2), "d": "text"}:
    a value that is a Python literal is parsed, any other stays a string."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        out[k] = v
    return out


@contextlib.contextmanager
def process_group(device: str):
    """A tool's run in the process group that torch's launcher describes
    (``parallel.mesh.initialize_from_env``; none without one, and a group
    the caller already started is used as it is). Yields this rank's device
    (``local_device``: ``cuda`` is ``cuda:LOCAL_RANK`` under a launcher),
    which must exist. A group joined here is destroyed at the end."""
    joined = initialize_from_env(device)
    try:
        yield require_device(local_device(device, world_size()))
    finally:
        if joined:
            dist.destroy_process_group()


def num_classes(cfg: Config) -> int:
    return (cfg.retina_head.num_classes if cfg.detector == "retinanet"
            else cfg.bbox_head.num_classes)


def load_dataset(cfg: Config, split: str, synthetic: int, synthetic_root: str,
                 shared: bool = True):
    """The config's dataset for ``split``, or with ``synthetic`` > 0 that
    many generated images under ``synthetic_root``. In a process group a
    ``shared`` root is written by rank 0 alone while the other ranks wait
    (``on_rank0``); otherwise each rank writes its own root (the generator
    is seeded: the same images)."""
    with_masks = cfg.mask_head is not None
    write = on_rank0 if shared else (lambda fn: fn())
    if cfg.data.dataset == "voc":
        root = cfg.data.root
        if synthetic:
            root = write(lambda: make_synthetic_voc(
                synthetic_root, num_images=synthetic, num_classes=min(num_classes(cfg), 20),
                split=split, year=cfg.data.voc_year))
        return VocDataset(root, split=split, year=cfg.data.voc_year)
    if synthetic:
        ann, img_dir = write(lambda: make_synthetic_coco(
            synthetic_root, num_images=synthetic, split=split, num_classes=num_classes(cfg)))
        return CocoDataset(ann, img_dir, with_masks=with_masks)
    return CocoDataset(
        os.path.join(cfg.data.root, "annotations", f"instances_{split}.json"),
        os.path.join(cfg.data.root, split), with_masks=with_masks)


# Seeded random weights score every class near its prior: RetinaNet's sigmoid
# scores lie in 0.0099-0.013 (its prior bias), R-FCN's softmax within 0.002 of
# 1/81 (seed 0, 256x320, f32, on the CPU): under the test threshold of 0.05
# and, among thousands of candidates, closer to each other than the card's
# and the CPU's rounding. Their class convs' weights are scaled, so that the
# scores spread as a trained net's (there, RetinaNet's top 40 lie in
# 0.65-0.81 and R-FCN's in 0.69-0.88).
CLASS_CONV_SCALE = {"retinanet": ("head.cls_score", 30.0), "rfcn": ("rfcn_cls", 100.0)}


def seeded_model(cfg: Config, device, train: bool = False) -> torch.nn.Module:
    """``build_detector(cfg, seed=0)`` on ``device``, its class conv scaled
    by ``CLASS_CONV_SCALE`` where the config has one."""
    model = build_detector(cfg, device=device, seed=0, train=train)
    if cfg.detector in CLASS_CONV_SCALE:
        name, k = CLASS_CONV_SCALE[cfg.detector]
        with torch.no_grad():
            model.get_submodule(name).weight.mul_(k)
    return model


def dcn_layers(model) -> list:
    from ..models.backbones.resnet import DeformConv

    return [m for m in model.modules() if isinstance(m, DeformConv)]


def seed_offset_convs(model, cfg: Config, raw, hw, gen: torch.Generator) -> None:
    """Overwrite every offset conv's weight (zero in the JAX init, which
    would make each DCN a plain conv) with seeded normal noise scaled by
    1 / (sqrt(9 Cin) * RMS of the layer's input), so that its offsets have
    a std of about 1 cell. The RMS is measured layer by layer in one
    forward pass of ``raw`` in the model's compute dtype (each layer's
    input depends on the offsets before it)."""
    def pre(m, args):
        rms = args[0].float().pow(2).mean().sqrt()
        w = m.offset_conv.weight
        noise = torch.randn(w.shape, generator=gen).to(w.device)
        with torch.no_grad():
            w.copy_(noise / (rms * (9 * w.shape[1]) ** 0.5))

    hooks = [m.register_forward_pre_hook(pre) for m in dcn_layers(model)]
    try:
        infer_batch(model, cfg, raw, hw, model.compute_dtype)
    finally:
        for h in hooks:
            h.remove()


@torch.no_grad()
def infer_batch(model, cfg: Config, raw, hw, dtype, masks: bool = True, *, flip=None,
                scale_size: int | None = None, out_hw=None) -> tuple:
    """One inference batch on the model's device, the JAX tools' ``forward``
    (``tools/bench_infer.py``): ``batch_transform`` of the uint8 canvases
    ``raw`` (B, h, w, 3) with their image sizes ``hw`` (B, 2),
    ``forward_test``, the detector's postprocess (``detector_fns``:
    ``rcnn_postprocess`` or ``retinanet_postprocess``) and, for a model
    with a mask head unless ``masks`` is false, ``mask_probs``
    (``dets["masks"]``, (B, D, M, M)). By default no image is flipped and
    the images are resized to ``cfg.data.scale`` on the (pad_h, pad_w)
    canvas. Returns (dets, outputs); the outputs keep the batch's
    ``im_info``. Spans (``utils/profiling.py``): ``infer.batch`` (its item
    id the recorder's count of root spans), with ``infer.transform``,
    ``infer.forward``, ``infer.postprocess`` and ``infer.masks``."""
    with annotate("infer.batch"):
        d = cfg.data
        out_hw = (d.pad_h, d.pad_w) if out_hw is None else out_hw
        b = raw.shape[0]
        with annotate("infer.transform"):
            if flip is None:
                flip = torch.zeros((b,), dtype=torch.bool, device=raw.device)
            gt_boxes = torch.zeros((b, d.max_gt, 4), device=raw.device)  # no detection reads them
            tb = batch_transform(raw, hw, flip, gt_boxes, out_hw=out_hw,
                                 scale_size=d.scale if scale_size is None else scale_size,
                                 max_size=d.max_size, mean=d.mean, std=d.std, dtype=dtype)
        with annotate("infer.forward"):
            out = model.forward_test(tb["images"], tb["im_info"])
        out["im_info"] = tb["im_info"]
        with annotate("infer.postprocess"):
            dets = detector_fns(cfg).postprocess(out, cfg, out_hw, tb["im_info"])
        if masks and getattr(model, "mask_head", None) is not None:
            with annotate("infer.masks"):
                dets["masks"] = mask_probs(model, out, dets, tb["im_info"])
        return dets, out


def bench_log(msg: str) -> None:
    """A throughput tool's log line, on stderr: stdout holds only its JSON line."""
    print(msg, file=sys.stderr, flush=True)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def log_run_facts(device: torch.device, launches: dict) -> None:
    """The precision flags the run had (torch's defaults: a throughput tool
    sets none), its peak device memory and its kernels' launches, the last
    as ``launches {json}`` for a caller to parse."""
    bench_log(f"precision: torch.backends.cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
              f"{torch.get_float32_matmul_precision()!r}")
    if device.type == "cuda":
        bench_log(f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    else:
        bench_log("peak memory: not measured on the CPU")
    bench_log(f"launches {json.dumps(launches)}")
