"""Port parity, evaluation loop and training loop: ``paste_masks``, the
``Evaluator`` (bbox, flip TTA, segm, the VOC protocol) and
``Trainer.fit_epochs`` of ``mxdetection_tpu_torch`` against the JAX
package's, on the same converted weights and the same JAX-made synthetic
images, on the CPU in float32.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxdetection_tpu.parallel.dist as jdist
from mxdetection_tpu.config import load_config as jload_config
from mxdetection_tpu.data import CocoDataset as JCocoDataset
from mxdetection_tpu.data import VocDataset as JVocDataset
from mxdetection_tpu.data import make_synthetic_coco, make_synthetic_voc
from mxdetection_tpu.eval import Evaluator as JEvaluator
from mxdetection_tpu.eval.evaluator import paste_mask as jpaste_mask
from mxdetection_tpu.models.registry import build_detector as jbuild_detector
from mxdetection_tpu.train.trainer import make_optimizer as jmake_optimizer

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.data.coco import CocoDataset
from mxdetection_tpu_torch.data.loader import DetectionLoader
from mxdetection_tpu_torch.data.voc import VocDataset
from mxdetection_tpu_torch.eval.evaluator import Evaluator, paste_masks
from mxdetection_tpu_torch.eval.rle import rle_area, rle_iou
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.train.trainer import Trainer
from mxdetection_tpu_torch.utils.convert import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

SMALL = {"data.pad_h": 128, "data.pad_w": 128, "data.scale": 96, "data.max_size": 128,
         "data.max_gt": 8, "backbone.dtype": "float32"}


def test_paste_mask_matches_jax():
    """``paste_masks`` (Pillow's fixed-point bilinear resize, batched in
    torch) against the JAX evaluator's ``paste_mask`` (Pillow) on 300 seeded
    masks and boxes, shrunk under 28 px and grown, partly off the image:
    pixel for pixel."""
    rng = np.random.RandomState(0)
    masks = ((rng.rand(300, 28, 28) + np.linspace(0, 1, 28)) / 2).astype(np.float32)
    side = np.where(rng.rand(300, 2) < 0.4, rng.uniform(0.3, 28, (300, 2)),
                    rng.uniform(28, 300, (300, 2)))
    xy = rng.uniform(-20, 300, (300, 2))
    boxes = np.concatenate([xy, xy + side], 1).astype(np.float32)
    got = paste_masks(torch.from_numpy(masks), boxes, 320, 360)
    n_set = 0
    for m, b, g in zip(masks, boxes, got):
        ref = jpaste_mask(m, b, 320, 360)
        np.testing.assert_array_equal(g, ref)
        n_set += int(ref.sum())
    assert n_set > 100_000


def bounded_variables(variables):
    """The JAX init leaves every FrozenBN at identity, and the random
    activations grow through the 16 blocks to thousands, where the last-bit
    differences of two summation orders move boxes by hundredths of a pixel.
    As the port's ``reset_parameters`` does, each block's last norm gets
    gamma 1/sqrt(16), which keeps the pyramid small."""
    bs = variables["batch_stats"]["backbone"]
    blocks = [k for k in bs if k.startswith("layer")]
    for k in blocks:
        bs[k]["bn3"]["gamma"] = bs[k]["bn3"]["gamma"] * len(blocks) ** -0.5
    return variables


def init_jax(cfg, masks=False):
    bundle = jbuild_detector(cfg)
    tb0 = {"images": jnp.zeros((1, 128, 128, 3)), "im_info": jnp.asarray([[128.0, 128, 1.0]]),
           "gt_boxes": jnp.zeros((1, 8, 4)), "gt_labels": jnp.zeros((1, 8), jnp.int32),
           "gt_valid": jnp.zeros((1, 8), bool)}
    if masks:
        tb0["box_masks"] = jnp.zeros((1, 8, 28, 28), jnp.uint8)
    variables = jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(0), tb0))
    return bundle, bounded_variables(jax.tree_util.tree_map(np.array, variables))


@pytest.fixture(scope="module")
def retina(tmp_path_factory):
    """RetinaNet at 128x128 on 4 JAX-made images; its class conv scaled by 30
    so that seeded scores spread over 0.06-0.14, above the 0.05 threshold
    (at the prior they sit at 0.01), as ``tools/common.py::CLASS_CONV_SCALE``."""
    root = tmp_path_factory.mktemp("retina")
    ann, img_dir = make_synthetic_coco(str(root), num_images=4, num_classes=3, seed=5)
    over = {**SMALL, "retina_head.num_classes": 3, "test.pre_nms_per_class": 200,
            "test.max_per_image": 20}
    bundle, variables = init_jax(jload_config("configs/retinanet_r50_fpn_1x.py").override(**over))
    variables["params"]["head"]["cls_score"]["kernel"] *= 30.0
    return over, bundle, variables, ann, img_dir, str(root)


@pytest.fixture(scope="module")
def mask(tmp_path_factory):
    root = tmp_path_factory.mktemp("mask")
    ann, img_dir = make_synthetic_coco(str(root), num_images=2, num_classes=3, seed=9)
    over = {**SMALL, "bbox_head.num_classes": 3, "bbox_head.num_samples": 16,
            "rpn.pre_nms_top_n_test": 128, "rpn.post_nms_top_n_test": 64,
            "test.pre_nms_per_class": 128, "test.max_per_image": 10}
    bundle, variables = init_jax(jload_config("configs/mask_rcnn_r50_fpn_1x.py").override(**over),
                                 masks=True)
    return over, bundle, variables, ann, img_dir, str(root)


def run_both(name, over, bundle, variables, jds, ds, with_masks=False, protocol="coco",
             monkeypatch=None):
    """The JAX ``Evaluator`` and the port's on the same weights and images;
    returns (JAX results, its per-image records, port results, port records)."""
    jrecords = []
    gather = jdist.all_gather_objects
    monkeypatch.setattr(jdist, "all_gather_objects",
                        lambda recs: (jrecords.extend(recs), gather(recs))[1])
    kw = dict(batch_size=2, raw_hw=(416, 416), with_masks=with_masks, protocol=protocol)
    jcfg = jload_config(f"configs/{name}.py").override(**over)
    jres = JEvaluator(jcfg, bundle, variables, jds, **kw).run(verbose=False)
    model = load_flax_variables(build_detector(load_config(name, over), device="cpu"), variables)
    ev = Evaluator(load_config(name, over), model, ds, **kw)
    res = ev.run(verbose=False)
    return jres, {r["image_id"]: r for r in jrecords}, res, ev.records


def check_records(records, jrecords, n_images):
    """Per image: labels equal, boxes within 1e-3 px, scores within 1e-5;
    returns the number of detections."""
    assert len(records) == len(jrecords) == n_images
    n = 0
    for r in records:
        j = jrecords[r["image_id"]]
        np.testing.assert_array_equal(r["labels"], j["labels"])
        np.testing.assert_allclose(r["boxes"], j["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r["scores"], j["scores"], rtol=0, atol=1e-5)
        n += len(r["labels"])
    return n


def check_results(res, jres):
    for k, v in jres.items():
        if k == "segm":
            check_results(res[k], v)
        elif k != "images_per_sec":
            assert abs(res[k] - v) <= 1e-6, (k, res[k], v)


@pytest.mark.parametrize("flip_tta", [False, True])
def test_evaluator_retinanet_matches_jax(retina, flip_tta, monkeypatch):
    """RetinaNet bbox eval, without and with flip TTA (two variants merged
    by the test NMS): the records and the COCO table against JAX's."""
    over, bundle, variables, ann, img_dir, _ = retina
    over = {**over, "test.flip_tta": flip_tta}
    jres, jrecords, res, records = run_both(
        "retinanet_r50_fpn_1x", over, bundle, variables, JCocoDataset(ann, img_dir),
        CocoDataset(ann, img_dir), monkeypatch=monkeypatch)
    assert check_records(records, jrecords, 4) == 80
    check_results(res, jres)
    assert res["num_images"] == 4 and np.isfinite(res["images_per_sec"])


def test_evaluator_voc_protocol_matches_jax(retina, monkeypatch):
    """The VOC branch (``evaluate_voc`` on the merged records) on a
    JAX-made VOC set."""
    over, bundle, variables, _, _, root = retina
    voc = make_synthetic_voc(os.path.join(root, "voc"), num_images=4, seed=2)
    jres, jrecords, res, records = run_both(
        "retinanet_r50_fpn_1x", over, bundle, variables, JVocDataset(voc), VocDataset(voc),
        protocol="voc", monkeypatch=monkeypatch)
    assert check_records(records, jrecords, 4) == 80
    assert res["mAP"] == jres["mAP"] and res["per_class"] == jres["per_class"]


@pytest.mark.parametrize("flip_tta", [False, True])
def test_evaluator_mask_rcnn_segm_matches_jax(mask, flip_tta, monkeypatch):
    """Mask R-CNN bbox + segm eval, without and with flip TTA (the mask head
    re-run on the merged boxes against both variants' pyramids): the
    records, the pasted masks' RLEs (IoU >= 0.99 with JAX's; equal in this
    run) and both tables."""
    over, bundle, variables, ann, img_dir, _ = mask
    over = {**over, "test.flip_tta": flip_tta}
    jres, jrecords, res, records = run_both(
        "mask_rcnn_r50_fpn_1x", over, bundle, variables,
        JCocoDataset(ann, img_dir, with_masks=True), CocoDataset(ann, img_dir, with_masks=True),
        with_masks=True, monkeypatch=monkeypatch)
    assert check_records(records, jrecords, 2) == 20
    areas = []
    for r in records:
        for a, b in zip(r["rles"], jrecords[r["image_id"]]["rles"], strict=True):
            assert a == b or rle_iou(a, b) >= 0.99
            areas.append(rle_area(a))
    assert sum(a > 0 for a in areas) >= 5, areas
    check_results(res, jres)


def test_fit_epochs(tmp_path):
    """Two steps of ``fit_epochs`` over the port's loader at 128x128: every
    step logged with the lr of the JAX schedule at that step, finite losses,
    one JSON line a logged step, ``on_metrics`` called for each."""
    ann, img_dir = make_synthetic_coco(str(tmp_path), num_images=4, num_classes=3, seed=1)
    over = {**SMALL, "bbox_head.num_classes": 3, "bbox_head.num_samples": 16,
            "rpn.pre_nms_top_n_train": 100, "rpn.post_nms_top_n_train": 50,
            "data.batch_size_per_device": 2}
    cfg = load_config("faster_rcnn_r50_fpn_1x", over)
    loader = DetectionLoader(CocoDataset(ann, img_dir), batch_size=2, max_gt=8, seed=0,
                             num_workers=2)
    assert loader.steps_per_epoch() == 2
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=loader.steps_per_epoch())
    seen = []
    path = str(tmp_path / "metrics.jsonl")
    history = trainer.fit_epochs(loader, 1, log_every=1, on_metrics=seen.append,
                                 metrics_file=path)
    _, jlr = jmake_optimizer(jload_config("configs/faster_rcnn_r50_fpn_1x.py").override(**over), 2)
    assert [m["step"] for m in history] == [1, 2] and seen == history
    for m in history:
        assert m["lr"] == float(jlr(m["step"])) and m["epoch"] == 0
        assert np.isfinite(m["loss"]) and m["imgs_per_sec"] > 0
    with open(path) as fh:
        assert [json.loads(line) for line in fh] == history
