"""Port parity, data and evaluation: Soft-NMS and box voting, the RLE codecs,
the COCO and VOC evaluators, the datasets, the loader and pretrained loading
of ``mxdetection_tpu_torch`` against the JAX package's functions, on inputs
made from numpy seeds. Pillow, which the JAX package draws and resizes with,
is the reference of the port's numpy rasterizer and resize.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from mxdetection_tpu.config import TestCfg as EvalCfg
from mxdetection_tpu.data import CocoDataset as JCocoDataset
from mxdetection_tpu.data import DetectionLoader as JDetectionLoader
from mxdetection_tpu.data import VocDataset as JVocDataset
from mxdetection_tpu.data import make_synthetic_coco as jmake_coco
from mxdetection_tpu.data import make_synthetic_voc as jmake_voc
from mxdetection_tpu.data import voc as jvoc
from mxdetection_tpu.data.coco import rasterize_full_mask as jrasterize_full
from mxdetection_tpu.eval import coco_eval as jcoco_eval
from mxdetection_tpu.eval import rle as jrle
from mxdetection_tpu.ops import nms as jnms

from mxdetection_tpu_torch.data import coco as tcoco
from mxdetection_tpu_torch.data import images as timages
from mxdetection_tpu_torch.data import voc as tvoc
from mxdetection_tpu_torch.data.loader import DetectionLoader
from mxdetection_tpu_torch.eval import coco_eval as tcoco_eval
from mxdetection_tpu_torch.eval import rle as trle
from mxdetection_tpu_torch.eval import rle_native as trle_native
from mxdetection_tpu_torch.ops import nms as tnms

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- Soft-NMS, box voting


def soft_nms_problems(seed, p=3, n=60):
    """p problems of n boxes: clustered (so scores decay), scores separated
    by at least 1e-3 but for two exact ties, two identical boxes a problem,
    and padded rows (valid False) with NaN coordinates."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 180, (p, 6, 2))
    c = centers[np.arange(p)[:, None], rng.randint(0, 6, (p, n))]
    wh = rng.uniform(10, 50, (p, n, 2))
    jit = rng.randn(p, n, 2) * 4
    boxes = np.concatenate([c + jit - wh / 2, c + jit + wh / 2], -1).astype(np.float32)
    boxes[:, 7] = boxes[:, 3]                     # identical boxes
    scores = (rng.permutation(n * p).reshape(p, n) * 1e-3 + 0.1).astype(np.float32)
    scores[:, 11] = scores[:, 5]                  # exact ties: the first index wins
    scores[:, 12] = scores[:, 5]
    labels = rng.randint(0, 4, (p, n))
    valid = rng.rand(p, n) > 0.15
    valid[:, [3, 5, 7, 11, 12]] = True
    boxes[~valid] = np.nan
    return boxes, scores, labels, valid


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches_jax(method):
    """Batched ``soft_nms`` and ``class_aware_soft_nms`` against the JAX
    functions vmapped: the same picks (boxes and labels bit-identical),
    scores within 1e-6; the tie resolves to the lower index in both."""
    boxes, scores, labels, valid = soft_nms_problems(1)
    kw = dict(method=method, iou_thr=0.3, sigma=0.5, score_thr=1e-3)
    got = tnms.soft_nms(T(boxes), T(scores), 40, valid=T(valid), **kw)
    ref = jax.vmap(lambda b, s, v: jnms.soft_nms(b, s, 40, valid=v, **kw))(boxes, scores, valid)
    np.testing.assert_array_equal(N(got[0]), N(ref[0]))
    np.testing.assert_allclose(N(got[1]), N(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N(got[2]), N(ref[2]))
    assert N(got[2]).sum() > 60
    got = tnms.class_aware_soft_nms(T(boxes), T(scores), T(labels), 40, valid=T(valid), **kw)
    ref = jax.vmap(lambda b, s, lab, v: jnms.class_aware_soft_nms(b, s, lab, 40, valid=v, **kw))(
        boxes, scores, labels, valid)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(N(got[i]), N(ref[i]))
    np.testing.assert_allclose(N(got[1]), N(ref[1]), rtol=0, atol=1e-6)
    # the identical pair: one pick keeps its score, the other is decayed
    # (linear: to 0, dropped), never NaN
    assert np.isfinite(N(got[1])).all()


def test_soft_nms_scan_ties_and_padding():
    """Exact ties pick the lowest index; an all-padding problem picks
    nothing; identical boxes decay to exactly 0 (linear) without NaN."""
    boxes = np.asarray([[[0, 0, 10, 10]] * 4, [[0, 0, 10, 10]] * 4], np.float32)
    scores = np.asarray([[0.5, 0.9, 0.9, 0.9], [0.5, 0.5, 0.5, 0.5]], np.float32)
    valid = np.asarray([[True] * 4, [False] * 4])
    idx, sv = tnms._soft_nms_scan(T(boxes), T(scores), 4, "linear", 0.3, 0.5, T(valid))
    jidx, jsv = jax.vmap(lambda b, s, v: jnms._soft_nms_scan(b, s, 4, "linear", 0.3, 0.5, v))(
        boxes, scores, valid)
    np.testing.assert_array_equal(N(idx)[0], N(jidx)[0])
    np.testing.assert_array_equal(N(sv), N(jsv))
    assert N(idx)[0, 0] == 1 and N(sv)[0, 1] == 0.0 and np.isneginf(N(sv)[1]).all()
    with pytest.raises(ValueError, match="soft-NMS method"):
        tnms._soft_nms_scan(T(boxes), T(scores), 2, "median", 0.3, 0.5, None)


def test_box_voting_matches_jax():
    """Batched ``box_voting`` against the JAX function vmapped, within 1e-6
    of the largest coordinate (the weighted sums are matmuls, summed in
    another order than XLA's); invalid kept rows and rows without weight
    keep their coordinates."""
    boxes, scores, labels, valid = soft_nms_problems(2)
    boxes = np.nan_to_num(boxes)
    kb, _, kl, kv = tnms.class_aware_nms(T(boxes), T(scores), T(labels), 0.5, 30, valid=T(valid))
    got = tnms.box_voting(kb, kl, kv, T(boxes), T(scores), T(labels), 0.8, pool_valid=T(valid))
    ref = jax.vmap(lambda a, b, c, d, e, f, g: jnms.box_voting(a, b, c, d, e, f, 0.8, g))(
        N(kb), N(kl), N(kv), boxes, scores, labels, valid)
    np.testing.assert_allclose(N(got), N(ref), rtol=0, atol=1e-6 * np.abs(N(ref)).max())
    moved = np.abs(N(got) - N(kb)).max(-1) > 0
    assert moved.sum() > 10 and not moved[~N(kv)].any()


@pytest.mark.parametrize("method", ["greedy", "soft_linear", "soft_gaussian"])
@pytest.mark.parametrize("vote", [False, True])
def test_class_aware_nms_from_cfg_matches_jax(method, vote):
    boxes, scores, labels, valid = soft_nms_problems(3)
    cfg = EvalCfg(nms_method=method, bbox_vote=vote, max_per_image=25, score_thr=0.12)
    got = tnms.class_aware_nms_from_cfg(cfg, T(boxes), T(scores), T(labels), valid=T(valid))
    ref = jax.vmap(lambda b, s, lab, v: jnms.class_aware_nms_from_cfg(cfg, b, s, lab, valid=v))(
        boxes, scores, labels, valid)
    np.testing.assert_allclose(N(got[0]), N(ref[0]), rtol=0,
                               atol=1e-6 * np.abs(N(ref[0])).max() if vote else 0)
    np.testing.assert_allclose(N(got[1]), N(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N(got[2]), N(ref[2]))
    np.testing.assert_array_equal(N(got[3]), N(ref[3]))
    assert N(got[3]).sum() > 30


# ------------------------------------------------------------------- RLE


def random_masks(seed, n=12, h=37, w=53):
    rng = np.random.RandomState(seed)
    masks = [rng.rand(h, w) > 0.6 for _ in range(n // 2)]
    for _ in range(n - len(masks) - 2):
        m = np.zeros((h, w), bool)
        y0, x0 = rng.randint(0, h - 5), rng.randint(0, w - 5)
        m[y0:y0 + rng.randint(2, 20), x0:x0 + rng.randint(2, 30)] = True
        masks.append(m)
    return masks + [np.zeros((h, w), bool), np.ones((h, w), bool)]


@pytest.mark.parametrize("codec", ["numpy", "native"])
def test_rle_matches_jax(codec):
    """encode, decode, area, iou (crowd and not), compress_counts and the
    IoU matrix, bit-identical to the JAX package's numpy codec."""
    masks = random_masks(4)
    if codec == "numpy":
        enc, dec, area = trle.encode_rle, trle.decode_rle, trle.rle_area
        iou = trle.rle_iou
    else:
        assert trle_native.implementation() == "native", "the native codec did not build"
        enc, dec, area, iou = (trle_native.encode, trle_native.decode, trle_native.area,
                               trle_native.iou)
    rles = [enc(m) for m in masks]
    for m, r in zip(masks, rles):
        ref = jrle.encode_rle(m)
        assert r == ref
        np.testing.assert_array_equal(dec(r), jrle.decode_rle(ref))
        assert area(r) == jrle.rle_area(ref) == int(m.sum())
        s = trle.compress_counts(r["counts"])
        assert s == jrle.compress_counts(ref["counts"])
        assert trle._uncompress_counts(s) == ref["counts"]
    for a in rles[:6]:
        for b in rles[4:]:
            for crowd in (False, True):
                assert iou(a, b, crowd) == jrle.rle_iou(a, b, crowd)
    if codec == "native":
        crowd = np.arange(len(rles)) % 3 == 0
        got = trle_native.iou_matrix(rles, rles, crowd)
        ref = np.asarray([[jrle.rle_iou(a, b, c) for b, c in zip(rles, crowd)] for a in rles])
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------- COCO evaluator


def coco_case(seed, segm):
    """gts over 5 images x 4 classes with crowd boxes and every area range,
    and noisy detections (duplicates, misses, false positives)."""
    rng = np.random.RandomState(seed)
    h = w = 200
    gts, dets = [], []
    for img in range(5):
        boxes, scores, labels, masks = [], [], [], []
        for _ in range(rng.randint(2, 7)):
            side = rng.choice([12.0, 50.0, 130.0]) * rng.uniform(0.7, 1.3)
            x, y = rng.uniform(0, w - side, 2)
            b = np.asarray([x, y, x + side, y + side * rng.uniform(0.6, 1.2)])
            b[3] = min(b[3], h - 1)
            cat = int(rng.randint(4))
            gt = {"image_id": img, "category": cat, "bbox": b.tolist(),
                  "area": float((b[2] - b[0]) * (b[3] - b[1])),
                  "iscrowd": bool(rng.rand() < 0.15)}
            if segm:
                m = np.zeros((h, w), bool)
                m[int(b[1]):int(b[3]), int(b[0]):int(b[2])] = True
                gt["mask"] = jrle.encode_rle(m)
            gts.append(gt)
            for _ in range(rng.randint(0, 3)):
                db = b + rng.randn(4) * side * 0.1
                boxes.append(db)
                scores.append(rng.rand())
                labels.append(cat if rng.rand() < 0.8 else int(rng.randint(4)))
                if segm:
                    m = np.zeros((h, w), bool)
                    x0, y0, x1, y1 = np.maximum(db, 0).astype(int)
                    m[y0:y1, x0:x1] = True
                    masks.append(jrle.encode_rle(m))
        dets.append((img, np.asarray(boxes).reshape(-1, 4), np.asarray(scores), np.asarray(labels),
                     masks if segm else None))
    return gts, dets


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("native", [False, True])
def test_coco_evaluator_matches_jax(iou_type, native, monkeypatch):
    """Every key of the table within 1e-9 of the JAX ``CocoEvaluator``'s,
    with the Python matcher (the native one taken away) and with the native
    one; crowd gts and every area range occur."""
    gts, dets = coco_case(5, iou_type == "segm")
    assert any(g["iscrowd"] for g in gts)
    if not native:
        monkeypatch.setattr(tcoco_eval, "native_matcher", lambda: None)
    ev = tcoco_eval.CocoEvaluator(gts, 4, iou_type)
    assert ev.matcher == ("native" if native else "python")
    ref = jcoco_eval.CocoEvaluator(gts, 4, iou_type)
    for img, b, s, lab, m in dets:
        ev.add(img, b, s, lab, masks=m)
        ref.add(img, b, s, lab, masks=m)
    got, want = ev.evaluate(), ref.evaluate()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert want["AP"] > 0.1 and all(want[f"AP_{a}"] >= 0 for a in ("small", "medium", "large"))
    assert tcoco_eval.format_table(got) == jcoco_eval.format_table(want)


# --------------------------------------------------------------------- VOC


def voc_detections(ds, seed):
    rng = np.random.RandomState(seed)
    dets = []
    for r in ds.records:
        b = np.concatenate([r.boxes + rng.randn(*r.boxes.shape) * 6,
                            rng.uniform(0, 200, (3, 4)).cumsum(-1)])
        dets.append({"image_id": r.image_id, "boxes": b, "scores": rng.rand(len(b)),
                     "labels": rng.randint(0, 3, len(b))})
    return dets


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return jmake_voc(str(tmp_path_factory.mktemp("voc")), num_images=10, seed=3)


def test_voc_dataset_and_eval_match_jax(voc_root):
    """``VocDataset`` records on the JAX-made set, ``voc_ap`` on both
    metrics and ``evaluate_voc`` (difficult gts included): exact."""
    ds, jds = tvoc.VocDataset(voc_root), JVocDataset(voc_root)
    assert len(ds) == len(jds) == 10
    for r, j in zip(ds.records, jds.records):
        assert (r.image_id, r.file, r.height, r.width) == (j.image_id, j.file, j.height, j.width)
        for k in ("boxes", "labels", "is_crowd"):
            np.testing.assert_array_equal(getattr(r, k), getattr(j, k))
        np.testing.assert_array_equal(ds.load_image(r), jds.load_image(j))
    jds.records[0].is_crowd[0] = ds.records[0].is_crowd[0] = True  # a difficult gt
    dets = voc_detections(ds, 6)
    for metric07 in (False, True):
        assert tvoc.evaluate_voc(dets, ds, use_07_metric=metric07) == \
            jvoc.evaluate_voc(dets, jds, use_07_metric=metric07)
    rng = np.random.RandomState(7)
    rec, prec = np.sort(rng.rand(30)), rng.rand(30)
    for metric07 in (False, True):
        assert tvoc.voc_ap(rec, prec, metric07) == jvoc.voc_ap(rec, prec, metric07)


def test_synthetic_voc_matches_jax(tmp_path, voc_root):
    """The port's synthetic VOC set (PPM images) has the JAX set's annotations."""
    root = tvoc.make_synthetic_voc(str(tmp_path), num_images=10, seed=3)
    ds, jds = tvoc.VocDataset(root), JVocDataset(voc_root)
    for r, j in zip(ds.records, jds.records):
        assert r.file.endswith(".ppm") and (r.height, r.width) == (j.height, j.width)
        np.testing.assert_array_equal(r.boxes, j.boxes)
        np.testing.assert_array_equal(r.labels, j.labels)
        assert ds.load_image(r).shape == (r.height, r.width, 3)


# ------------------------------------------------------------------ COCO set


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    return jmake_coco(str(root), num_images=11, size_range=(240, 400), num_classes=4,
                      seed=2)


def test_coco_dataset_matches_jax(coco_set, tmp_path):
    """``CocoDataset`` records on the JAX-made set: boxes, labels, crowd,
    areas and polygons exact; the box masks (convex polygons: rectangles and
    16-gon ellipses) and full-image masks equal Pillow's pixel for pixel.
    ``make_synthetic_coco`` of the port writes the same annotations."""
    ann, img_dir = coco_set
    ds = tcoco.CocoDataset(ann, img_dir, with_masks=True)
    jds = JCocoDataset(ann, img_dir, with_masks=True)
    n_masks = 0
    for r, j in zip(ds.records, jds.records, strict=True):
        assert (r.image_id, r.file, r.height, r.width) == (j.image_id, j.file, j.height, j.width)
        for k in ("boxes", "labels", "is_crowd", "areas"):
            np.testing.assert_array_equal(getattr(r, k), getattr(j, k))
        assert r.polygons == j.polygons
        np.testing.assert_array_equal(ds.get_box_masks(r), jds.get_box_masks(j))
        for polys in r.polygons:
            np.testing.assert_array_equal(tcoco.rasterize_full_mask(polys, r.height, r.width),
                                          jrasterize_full(polys, j.height, j.width))
            n_masks += 1
        np.testing.assert_array_equal(ds.load_image(r), jds.load_image(j))  # JPEG via Pillow
    assert n_masks > 20
    ann2, _ = tcoco.make_synthetic_coco(str(tmp_path), num_images=11, size_range=(240, 400),
                                        num_classes=4, seed=2)
    with open(ann) as f, open(ann2) as f2:
        a, b = json.load(f), json.load(f2)
    assert [dict(im, file_name=None) for im in a["images"]] == \
        [dict(im, file_name=None) for im in b["images"]]
    assert a["annotations"] == b["annotations"] and a["categories"] == b["categories"]


def pil_polygon(pts, h, w):
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(q) for q in pts], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def test_fill_polygon_against_pillow():
    """Pillow's ``ImageDraw.polygon`` vs ``fill_polygon`` on 300 seeded
    polygons: convex ones (rotated ellipse 16-gons, rectangles, partly off
    the canvas) equal pixel for pixel; concave star-shaped ones differ at
    their concave corners, where Pillow moves a few pixels. The bound, 8
    pixels a mask and 4 % of the polygon's pixels, sits above this set's
    worst (5 pixels, 3.0 %) and fails a fill that is off by a row or a
    column of any polygon wider than 8 pixels."""
    rng = np.random.RandomState(0)
    for c in range(300):
        h = w = 28 if c % 2 else 70
        kind = c % 3
        if kind == 0:
            t = np.linspace(0, 2 * np.pi, 17)[:-1] + rng.uniform(0, 1)
            cx, cy = rng.uniform(-5, h + 5, 2)
            rx, ry = rng.uniform(1, h * 0.7, 2)
            pts = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)
        elif kind == 1:
            x0, y0 = rng.uniform(-3, h, 2)
            x1, y1 = x0 + rng.uniform(0, 15), y0 + rng.uniform(0, 15)
            pts = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        else:
            n = rng.randint(5, 30)
            t = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(2, 14, n)
            pts = np.stack([np.cos(t), np.sin(t)], 1) * r[:, None] + rng.uniform(5, 23, 2)
            pts *= rng.uniform(0.5, 2.5)
        ref = pil_polygon(pts, h, w)
        got = np.zeros((h, w), np.uint8)
        tcoco.fill_polygon(got, pts)
        diff = int((got != ref).sum())
        if kind < 2:
            assert diff == 0, (c, diff)
        else:
            assert diff <= 8 and diff <= 0.04 * int(ref.sum()), (c, diff)


def test_images_ppm_and_resize(tmp_path):
    """PPM round trip, and ``resize_bilinear_u8`` (the loader's pre-shrink,
    ``bilinear_pass`` per channel) equal to Pillow's ``resize(BILINEAR)``,
    down and up, value for value."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (57, 91, 3)).astype(np.uint8)
    path = str(tmp_path / "a.ppm")
    timages.write_ppm(path, img)
    np.testing.assert_array_equal(timages.read_image(path), img)
    for oh, ow in ((20, 33), (57, 40), (120, 91), (5, 200), (1, 1)):
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR), np.uint8)
        np.testing.assert_array_equal(timages.resize_bilinear_u8(img, oh, ow), ref)


# -------------------------------------------------------------------- loader


@pytest.mark.parametrize("shard", [0, 1])
def test_loader_matches_jax(coco_set, shard):
    """Two epochs of ``DetectionLoader`` against the JAX loader's: shuffled,
    flipped, portrait buckets, 2 shards and wrap-around fill, a raw canvas
    smaller than some images (the pre-shrink) and box masks; every key
    bit-identical."""
    ann, img_dir = coco_set
    ds = tcoco.CocoDataset(ann, img_dir, with_masks=True)
    jds = JCocoDataset(ann, img_dir, with_masks=True)
    kw = dict(batch_size=2, raw_hw=(352, 352), max_gt=8, seed=4, num_workers=2,
              num_shards=2, shard_index=shard, with_masks=True, orient_buckets=True)
    loader, jloader = DetectionLoader(ds, **kw), JDetectionLoader(jds, **kw)
    assert loader.steps_per_epoch() == jloader.steps_per_epoch()
    size = {r.image_id: (r.height, r.width) for r in ds.records}
    portrait, shrunk = set(), 0
    for epoch in (0, 1):
        got, ref = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(got) == len(ref) == loader.steps_per_epoch()
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for k in r:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
            portrait.add(bool(g["portrait"]))
            shrunk += int((g["hw"] < [size[int(i)] for i in g["image_ids"]]).any(1).sum())
    assert portrait == {False, True} and shrunk > 0


def test_loader_raises_a_failed_decode(coco_set, tmp_path):
    """A missing image file fails the epoch with its error, not a short epoch."""
    ann, img_dir = coco_set
    ds = tcoco.CocoDataset(ann, img_dir)
    ds.records[3].file = str(tmp_path / "missing.ppm")
    with pytest.raises(FileNotFoundError, match="missing.ppm"):
        list(DetectionLoader(ds, batch_size=4, num_workers=2, shuffle=False).epoch(0))


# --------------------------------------------------------------- pretrained


def test_load_backbone_matches_jax(tmp_path):
    """A synthetic torchvision-keyed ResNet-50 state dict: the JAX path
    (``convert_state_dict`` -> .npz -> ``load_backbone``) and the port's
    (``torch.save`` -> ``load_backbone``) give the same backbone outputs; a
    key the backbone has no place for raises; a key the file lacks keeps
    its initialisation."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from convert_pretrained import convert_state_dict
    from test_pretrained import synthetic_torch_sd
    from mxdetection_tpu.models.backbones.resnet import ResNet as JResNet
    from mxdetection_tpu.utils.pretrained import load_backbone as jload_backbone

    from mxdetection_tpu_torch.models.backbones.resnet import ResNet
    from mxdetection_tpu_torch.utils.pretrained import load_backbone

    sd = synthetic_torch_sd(50, seed=3)
    sd["fc.weight"] = np.zeros((10, 2048), np.float32)
    sd["bn1.num_batches_tracked"] = np.asarray(0)
    np.savez(tmp_path / "r50.npz", **convert_state_dict(sd, 50))
    jmodel = JResNet(depth=50, dtype=jnp.float32)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x))
    v = jload_backbone({"params": {"backbone": v["params"]},
                        "batch_stats": {"backbone": v["batch_stats"]}}, str(tmp_path / "r50.npz"))
    ref = jax.jit(jmodel.apply)({"params": v["params"]["backbone"],
                                 "batch_stats": v["batch_stats"]["backbone"]}, x)

    torch.save({k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()}, tmp_path / "r50.pth")
    model = ResNet(depth=50).eval()
    assert load_backbone(model, str(tmp_path / "r50.pth")) == len(sd) - 2
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, r in zip(got, ref, strict=True):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())

    partial = {k: torch.from_numpy(a) for k, a in sd.items() if not k.startswith("layer4.")}
    torch.save(partial, tmp_path / "partial.pth")
    fresh = ResNet(depth=50)
    before = fresh.layer4_block0.conv1.weight.clone()
    load_backbone(fresh, str(tmp_path / "partial.pth"))
    assert torch.equal(fresh.layer4_block0.conv1.weight, before)
    np.testing.assert_array_equal(fresh.stem_conv.weight.detach().numpy(), sd["conv1.weight"])
    torch.save({**partial, "layer5.0.conv1.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    with pytest.raises(KeyError, match="layer5.0.conv1.weight"):
        load_backbone(fresh, str(tmp_path / "extra.pth"))


def test_profiling_trace(tmp_path):
    """``trace`` writes a Chrome trace of the region; ``annotate`` names a span in it."""
    import gzip

    from mxdetection_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)):
        with annotate("mxdet_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with gzip.open(tmp_path / "trace.json.gz", "rt") as fh:
        assert "mxdet_span" in fh.read()
