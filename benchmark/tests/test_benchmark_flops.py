"""The yardstick's counts against hand-worked numbers, and the model FLOP
count against torch's own FLOP counter over the program's forward pass."""

import json
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, spec


def test_bound_picks_the_larger_side():
    # 3.35 GB at 3.35 TB/s: 1 ms; 67 GFLOP f32: 1 ms; 989 GFLOP bf16: 1 ms
    assert flops.bound(3.35e9, 0.0) == pytest.approx(1e-3)
    assert flops.bound(3.35e9, 67e9 * 2) == pytest.approx(2e-3)
    assert flops.bound(1.0, 0.0, 989e9 * 3) == pytest.approx(3e-3)


def test_roi_counts():
    # 1000 rois, 7x7 bins, 2x2 samples, 256 channels, 4 taps x (mul + add)
    assert flops.roi_flops(1000, 7, 2, 256) == 1000 * 49 * 4 * 256 * 8
    # K1: 10,000 touched pixels and 1000 outputs of 7x7x256 bf16 plus 21 B a roi
    nbytes = 10_000 * 256 * 2 + 1000 * 49 * 256 * 2 + 1000 * 21
    assert flops.roi_align_fwd_bound(1000, 1000, 10_000, 7, 256) == pytest.approx(nbytes / 3.35e12)
    # K3: g read, 200,000 map pixels written
    nbytes = 1000 * 49 * 256 * 2 + 200_000 * 256 * 2 + 1000 * 21
    assert flops.roi_align_bwd_bound(1000, 200_000, 7, 256) == pytest.approx(nbytes / 3.35e12)


def test_dcn_bound_of_one_layer():
    # one stage-3 layer of a batch of 8: 52x84, 256 channels, stride 1
    b, h, w, c = 8, 52, 84, 256
    m = b * h * w
    nbytes = b * h * w * c * 2 + m * 18 * 4 + 9 * c * c * 2 + m * c * 2
    want = max(nbytes / 3.35e12, 2.0 * m * 9 * c * c / 989e12, 7.0 * m * 9 * c / 67e12)
    assert flops.dcn_bound(b, h, w, c, 1) == pytest.approx(want)


def test_live_corners_and_dcn_layers():
    off = torch.zeros((1, 3, 3, 18))  # on the grid: one live corner a tap inside the map
    # 3x3 output at stride 1 on a 3x3 map: taps inside the map
    inside = sum(1 for i in range(3) for j in range(3) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if 0 <= i + dy <= 2 and 0 <= j + dx <= 2)
    assert flops.live_corners(off, 3, 3, 1) == inside
    off[..., 0::2] = 0.5  # half a cell down: two live corners where both rows are inside
    assert flops.live_corners(off, 3, 3, 1) > inside
    m = spec.load_json(os.path.join(spec.HERE, "configs", "cascade_r101_dcn.json"))["model"]
    layers = flops.dcn_layers(m, (832, 1344))
    assert len(layers) == 4 + 23 + 3
    assert layers[0] == (208, 336, 128, 2) and layers[1] == (104, 168, 128, 1)
    assert layers[-1] == (26, 42, 512, 1)


def test_touched_pixels_of_one_roi():
    m = spec.load_json(os.path.join(spec.HERE, "configs", "faster_r50_fpn.json"))["model"]
    levels = [(208, 336), (104, 168), (52, 84), (26, 42)]
    # a 56x56 box at (100, 100) lands on P2 (k = floor(4 + log2(56/224)) = 2): the
    # samples span map cells 25..39 on each axis, with both corners live
    rois = torch.tensor([[[100.0, 100.0, 156.0, 156.0]]])
    n = flops.touched_pixels(rois, torch.ones((1, 1), dtype=torch.bool), levels, m)
    assert n == 15 * 15
    assert flops.touched_pixels(rois, torch.zeros((1, 1), dtype=torch.bool), levels, m) == 0


def conf_of(config: str) -> dict:
    return spec.load_json(os.path.join(spec.HERE, "configs", f"{config}.json"))


def tiny_model(config: str):
    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.registry import build_detector

    from benchmark.tests.tiny import TINY

    conf = conf_of(config)
    cfg = load_config(conf["zoo"], {**conf["overrides"], **TINY, "backbone.dtype": "float32"})
    m = json.loads(json.dumps(__import__("dataclasses").asdict(cfg)))
    return build_detector(cfg, device="cpu", seed=0), cfg, m


@pytest.mark.parametrize("config", ["faster_r50_fpn", "cascade_r101_dcn"])
def test_model_flops_equal_torch_flop_counter(config):
    """Every conv, deformable product and linear of the program's forward
    pass, as torch counts them, equals the benchmark's count from the
    configuration's shapes."""
    model, cfg, m = tiny_model(config)
    hw = (cfg.data.pad_h, cfg.data.pad_w)
    images = torch.randn((1, *hw, 3)).to(memory_format=torch.channels_last)
    info = torch.tensor([[hw[0], hw[1], 1.0]])
    counter = FlopCounterMode(display=False)
    with counter:
        model.forward_test(images, info)
    rois = m["rpn"]["post_nms_top_n_test"]
    # the deformable product runs inside the operator mxdet::deform_conv2d,
    # which the counter sees whole and does not count: add 2 * 9 C * C a pixel
    dcn = sum(flops.conv_flops(c, c, 3, -(-h // s), -(-w // s))
              for h, w, c, s in flops.dcn_layers(m, hw))
    assert (dcn > 0) == (config == "cascade_r101_dcn")
    fam = spec.family(conf_of(config)["family"])
    assert counter.get_total_flops() + dcn == pytest.approx(fam.model_flops(m, hw, rois), rel=1e-9)
    assert math.isfinite(fam.model_flops(m, (832, 1344), 1000))
