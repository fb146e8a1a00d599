"""Port parity, throughput tools: ``tools/common.py::infer_batch`` against
the JAX ``tools/bench_infer.py`` forward on the same converted weights and
the bench's own canvases, the JSON lines of ``tools.bench_infer`` and
``tools.bench_train``, ``bench_train``'s batch against the JAX tool's, and
``chip_smoke.py::detect`` and ``Evaluator.forward`` against the one
composition they share, on the CPU in float32.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from __graft_entry__ import _flagship_cfg  # noqa: E402
from mxdetection_tpu.data.transforms import batch_transform as jbatch_transform
from mxdetection_tpu.models.registry import build_detector as jbuild_detector

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.data.coco import CocoDataset, make_synthetic_coco
from mxdetection_tpu_torch.data.transforms import batch_transform
from mxdetection_tpu_torch.eval.evaluator import Evaluator
from mxdetection_tpu_torch.models.detectors.rcnn import mask_probs
from mxdetection_tpu_torch.models.registry import build_detector, detector_fns
from mxdetection_tpu_torch.tools import bench_infer, bench_train
from mxdetection_tpu_torch.tools.common import infer_batch, seeded_model
from mxdetection_tpu_torch.utils.convert import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_evaluator import bounded_variables  # noqa: E402
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

import chip_smoke  # noqa: E402

# ``__graft_entry__._flagship_cfg(small=True)``'s overrides, in f32
SMALL = {"data.pad_h": 128, "data.pad_w": 128, "data.scale": 96, "data.max_size": 128,
         "data.max_gt": 8, "bbox_head.num_samples": 64,
         "rpn.pre_nms_top_n_train": 256, "rpn.post_nms_top_n_train": 128,
         "rpn.pre_nms_top_n_test": 256, "rpn.post_nms_top_n_test": 128,
         "test.pre_nms_per_class": 256, "backbone.dtype": "float32"}
# the tools' tests run smaller still
TINY = {**SMALL, "data.pad_h": 64, "data.pad_w": 64, "data.scale": 48, "data.max_size": 64,
        "bbox_head.num_samples": 32, "rpn.pre_nms_top_n_train": 128,
        "rpn.post_nms_top_n_train": 64, "rpn.pre_nms_top_n_test": 128,
        "rpn.post_nms_top_n_test": 64, "test.pre_nms_per_class": 128}
TOOL_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
CONFIG_KEYS = {"config", "batch", "images_per_sec", "device"}
TRAIN_KEYS = {"metric", "value", "unit", "images_per_sec_per_chip", "global_batch", "device"}


def T(x):
    return torch.from_numpy(np.array(x))


# the heads take 3 classes: at 81 every seeded score sits under the 0.05
# threshold; Mask R-CNN keeps 20 detections an image (the mask head's cost)
PARITY = {**SMALL, "bbox_head.num_classes": 3}
MASK_PARITY = {**PARITY, "test.max_per_image": 20}


def jax_cfg(name, over):
    return _flagship_cfg(small=True, path=os.path.join(REPO, f"configs/{name}.py")).override(**over)


@pytest.fixture(scope="module")
def mask_variables():
    """Mask R-CNN's ``PRNGKey(0)`` variables at the small sizes (Faster
    R-CNN's are the same without ``mask_head``), each block's last FrozenBN
    gamma 1/sqrt(16) as in the evaluator tests."""
    jcfg = jax_cfg("mask_rcnn_r50_fpn_1x", MASK_PARITY)
    d = jcfg.data
    tb0 = {"images": jnp.zeros((1, d.pad_h, d.pad_w, 3)),
           "im_info": jnp.asarray([[128.0, 128.0, 1.0]]),
           "gt_boxes": jnp.zeros((1, d.max_gt, 4)),
           "gt_labels": jnp.zeros((1, d.max_gt), jnp.int32),
           "gt_valid": jnp.zeros((1, d.max_gt), bool),
           "box_masks": jnp.zeros((1, d.max_gt, 28, 28), jnp.uint8)}
    variables = jax.device_get(
        jax.jit(jbuild_detector(jcfg).init)(jax.random.PRNGKey(0), tb0))
    return bounded_variables(jax.tree_util.tree_map(np.array, variables))


@pytest.mark.parametrize("name,over", [("faster_rcnn_r50_fpn_1x", PARITY),
                                       ("mask_rcnn_r50_fpn_1x", MASK_PARITY)])
def test_infer_batch_matches_jax_bench_forward(mask_variables, name, over):
    """The JAX ``tools/bench_infer.py`` ``forward`` (transform, ``apply_eval``,
    ``postprocess`` and, for Mask R-CNN, the mask branch), rebuilt here from
    the JAX package's functions, against ``infer_batch`` on the same
    ``PRNGKey(0)`` weights (``load_flax_variables``) and the bench's
    ``RandomState(0)`` canvases at batch 2, at the flagship's small sizes in
    f32. As in the evaluator tests, each block's last FrozenBN gets gamma
    1/sqrt(16): at the JAX init's activations of thousands, boxes move by
    tenths of a pixel between summation orders (0.68 px on Faster). Valid
    and labels equal; boxes within 5e-3 px, scores within 1e-5 and mask
    probabilities within 1e-5 (measured: 5.3e-4 px, 3.6e-7 and 6.0e-8)."""
    jcfg = jax_cfg(name, over)
    d = jcfg.data
    pad_hw = (d.pad_h, d.pad_w)
    bundle = jbuild_detector(jcfg)
    variables = mask_variables
    if jcfg.mask_head is None:
        variables = {**variables, "params": {k: v for k, v in variables["params"].items()
                                             if k != "mask_head"}}

    def forward(variables, raw, hw, flip, gtb):
        tb = jbatch_transform(raw, hw, flip, gtb, out_hw=pad_hw, scale_size=d.scale,
                              max_size=d.max_size, mean=d.mean, std=d.std,
                              dtype=jnp.dtype(jcfg.backbone.dtype))
        out = bundle.apply_eval(variables, tb)
        dets = bundle.postprocess(out, jcfg, pad_hw, tb["im_info"])
        res = [dets["boxes"], dets["scores"], dets["labels"], dets["valid"]]
        if jcfg.mask_head is not None:
            logits = bundle.model_eval.apply(
                variables, out["pyramid"], dets["boxes"] * tb["im_info"][:, 2][:, None, None],
                dets["valid"], method=bundle.model_eval.mask_forward)
            cls_idx = jnp.clip(dets["labels"], 0, jcfg.bbox_head.num_classes - 1)
            sel = jnp.take_along_axis(logits, cls_idx[:, :, None, None, None], axis=-1)[..., 0]
            res.append(jax.nn.sigmoid(sel))
        return tuple(res)

    raw, hw = bench_infer.synthetic_input(2)
    ref = jax.device_get(jax.jit(forward)(variables, raw, hw, np.zeros(2, bool),
                                          np.zeros((2, d.max_gt, 4), np.float32)))

    cfg = load_config(name, over)
    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    dets, out = infer_batch(model, cfg, T(raw), T(hw), torch.float32)
    v = ref[3]
    assert v.sum() >= 40
    np.testing.assert_array_equal(dets["valid"].numpy(), v)
    np.testing.assert_array_equal(dets["labels"].numpy()[v], ref[2][v])
    np.testing.assert_allclose(dets["boxes"].numpy()[v], ref[0][v], rtol=0, atol=5e-3)
    np.testing.assert_allclose(dets["scores"].numpy()[v], ref[1][v], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["im_info"].numpy(),
                                  np.float32([[480.0, 640.0, 0.2]] * 2))
    if name.startswith("mask"):
        np.testing.assert_allclose(dets["masks"].numpy()[v], ref[4][v], rtol=0, atol=1e-5)
    else:
        assert "masks" not in dets


def test_synthetic_inputs_are_the_jax_tools():
    """The inference canvases are ``bench.py``'s and ``tools/bench_infer.py``'s
    (uint8 draws), ``bench_train``'s batch the JAX ``tools/bench_train.py``'s
    (int64 draws cast to uint8, which differ), array for array, the JAX
    recipe written out here as the tool writes it inside ``main``."""
    raw, hw = bench_infer.synthetic_input(3)
    np.testing.assert_array_equal(
        raw, np.random.RandomState(0).randint(0, 255, (3, 640, 640, 3), np.uint8))
    np.testing.assert_array_equal(hw, np.asarray([[480.0, 640.0]] * 3, np.float32))
    assert raw.dtype == np.uint8 and hw.dtype == np.float32

    for with_masks in (False, True):
        batch_size, g = 3, 100
        rng = np.random.RandomState(0)
        ref = {
            "raw": rng.randint(0, 255, (batch_size, 640, 640, 3)).astype(np.uint8),
            "hw": np.asarray([[480.0, 640.0]] * batch_size, np.float32),
            "flip": np.zeros((batch_size,), bool),
            "gt_boxes": np.tile(np.asarray(
                [[[50.0, 60, 300, 280], [200, 100, 500, 400]] + [[0, 0, 0, 0]] * (g - 2)],
                np.float32), (batch_size, 1, 1)),
            "gt_labels": np.zeros((batch_size, g), np.int32),
            "gt_valid": np.tile(np.asarray([[True, True] + [False] * (g - 2)]),
                                (batch_size, 1)),
        }
        if with_masks:
            bm = np.zeros((batch_size, g, 28, 28), np.uint8)
            bm[:, :2, 4:24, 4:24] = 1
            ref["box_masks"] = bm
        got = bench_train.train_batch(batch_size, g, with_masks)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not np.array_equal(got["raw"], raw)


def tool_line(capsys, main, argv) -> dict:
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def tiny_args():
    return [f"{k}={v}" for k, v in TINY.items()]


@pytest.mark.parametrize("config", [None, "faster_rcnn_r50_voc"])
def test_bench_infer_prints_one_json_line(capsys, config):
    """With the default config the line has ``bench.py``'s keys under the
    port's metric name, for another config ``tools/bench_infer.py``'s; both
    add ``device``."""
    argv = ([] if config is None else ["--config", config]) + [
        "--batch", "1", "--device", "cpu", "--override", *tiny_args()]
    line = tool_line(capsys, bench_infer.main, argv)
    if config is None:
        assert set(line) == TOOL_KEYS
        assert line["metric"] == "faster_rcnn_r50_fpn_coco_inference_images_per_sec_per_gpu"
        assert line["unit"] == "images/sec/gpu"
        assert abs(line["vs_baseline"] - line["value"] / 12.0) <= 0.01  # both rounded
        value = line["value"]
    else:
        assert set(line) == CONFIG_KEYS
        assert line["config"] == config and line["batch"] == 1
        value = line["images_per_sec"]
    assert line["device"] == "cpu" and np.isfinite(value) and value > 0


def test_bench_train_prints_one_json_line(capsys):
    """The JAX tool's keys and ``device``, on the SyncBN config: it trains
    without a process group (world size 1)."""
    config = "multihost_dp_faster_rcnn_v5p16"
    line = tool_line(capsys, bench_train.main, [config, "1", *tiny_args(), "--device", "cpu"])
    assert set(line) == TRAIN_KEYS
    assert line["metric"] == f"{config}_train_step_per_sec" and line["unit"] == "steps/sec"
    assert line["global_batch"] == 1 and line["device"] == "cpu"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert abs(line["images_per_sec_per_chip"] - line["value"]) <= 0.01  # both rounded


def test_tools_need_the_card_by_default():
    """Without ``--device cpu`` both tools ask for the card, and there is none here."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_infer.main(["--batch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train.main(["faster_rcnn_r50_fpn_1x", "1"])


def test_detect_and_evaluator_forward_are_infer_batch(tmp_path):
    """``chip_smoke.py::detect``, ``Evaluator.forward`` and ``infer_batch``
    give the same detections and mask probabilities as the composition they
    replaced (``batch_transform``, ``forward_test``, the postprocess,
    ``mask_probs``), written out here: Mask R-CNN with seeded weights on one
    small canvas, as is and with every image flipped at another scale."""
    cfg = load_config("mask_rcnn_r50_fpn_1x", {**MASK_PARITY, "test.max_per_image": 10})
    model = seeded_model(cfg, "cpu")
    ann, img_dir = make_synthetic_coco(str(tmp_path), num_images=1, num_classes=3)
    ev = Evaluator(cfg, model, CocoDataset(ann, img_dir), batch_size=1, with_masks=True)
    raw, hw = (T(a) for a in bench_infer.synthetic_input(1))
    gtb = torch.zeros((1, cfg.data.max_gt, 4))
    pad_hw = (cfg.data.pad_h, cfg.data.pad_w)

    def composed(flip, scale):
        with torch.no_grad():
            tb = batch_transform(raw, hw, flip, gtb, out_hw=pad_hw, scale_size=scale,
                                 max_size=cfg.data.max_size, mean=cfg.data.mean,
                                 std=cfg.data.std, dtype=torch.float32)
            out = model.forward_test(tb["images"], tb["im_info"])
            dets = detector_fns(cfg).postprocess(out, cfg, pad_hw, tb["im_info"])
            dets["masks"] = mask_probs(model, out, dets, tb["im_info"])
        return dets

    def same(got, ref):
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    no_flip = torch.zeros(1, dtype=torch.bool)
    ref = composed(no_flip, cfg.data.scale)
    assert int(ref["valid"].sum()) > 0
    same(infer_batch(model, cfg, raw, hw, torch.float32)[0], ref)
    same(chip_smoke.detect(model, cfg, raw, hw, torch.float32)[0], ref)
    batch = {"raw": raw, "hw": hw, "flip": no_flip, "gt_boxes": gtb}
    same(ev.forward(batch, cfg.data.scale, out_hw=pad_hw, want_masks=True), ref)

    ref = composed(torch.ones(1, dtype=torch.bool), 80)
    same(infer_batch(model, cfg, raw, hw, torch.float32, flip=torch.ones(1, dtype=torch.bool),
                     scale_size=80)[0], ref)
    got = ev.forward(batch, 80, flip=True, out_hw=pad_hw, want_masks=True, keep_pyramid=True)
    assert {"pyramid", "scale"} <= set(got)
    same({k: v for k, v in got.items() if k not in ("pyramid", "scale")}, ref)
    dets = ev.forward(batch, cfg.data.scale, out_hw=pad_hw)
    assert "masks" not in dets
