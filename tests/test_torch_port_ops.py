"""Port parity, ops: ``mxdetection_tpu_torch.ops`` / ``data`` against the JAX
package on the CPU, in float32, from the same numpy-seeded inputs.

On the CPU every port function runs its plain PyTorch version (the CUDA
kernels are held against those on the card by ``chip_smoke.py``). Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxdetection_tpu.config import TestCfg as EvalCfg
from mxdetection_tpu.data import transforms as jtf
from mxdetection_tpu.ops import anchors as janc
from mxdetection_tpu.ops import boxes as jbox
from mxdetection_tpu.ops import nms as jnms
from mxdetection_tpu.ops import proposals as jprop
from mxdetection_tpu.ops import roi_align as jra
from mxdetection_tpu.ops.pallas.nms import class_aware_nms_pallas, nms_pallas
from mxdetection_tpu.ops.pallas.roi_align import multilevel_roi_align_pallas

from mxdetection_tpu_torch.data import transforms as ttf
from mxdetection_tpu_torch.ops import anchors as tanc
from mxdetection_tpu_torch.ops import boxes as tbox
from mxdetection_tpu_torch.ops import nms as tnms
from mxdetection_tpu_torch.ops import proposals as tprop
from mxdetection_tpu_torch.ops import roi_align as tra
from mxdetection_tpu_torch.ops.cuda import nms as cuda_nms
from mxdetection_tpu_torch.ops.cuda import roi_align as cuda_roi_align
from mxdetection_tpu_torch.ops.cuda.nms import nms_mask_sorted_cuda
from mxdetection_tpu_torch.ops.cuda.roi_align import roi_align_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x)


def random_boxes(rng, n, size=200.0, degenerate=True):
    xy = rng.uniform(-20, size, (n, 2))
    wh = rng.uniform(0, 80, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if degenerate:
        b[::7] = 0.0                      # padding rows
        b[3::11, 2] = b[3::11, 0] - 5.0   # inverted boxes
    return b


# ---------------------------------------------------------------- boxes / anchors


def test_box_ops_exact():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 50), random_boxes(rng, 40)
    np.testing.assert_array_equal(N(tbox.box_area(T(a))), N(jbox.box_area(a)))
    np.testing.assert_array_equal(N(tbox.pairwise_iou(T(a), T(b))), N(jbox.pairwise_iou(a, b)))
    hw = np.asarray([150.0, 170.0], np.float32)
    np.testing.assert_array_equal(N(tbox.clip_boxes(T(a), T(hw))), N(jbox.clip_boxes(a, hw)))
    np.testing.assert_array_equal(N(tbox.flip_boxes(T(a), T(np.float32(170.0)))),
                                  N(jbox.flip_boxes(a, np.float32(170.0))))
    for min_size in (0.0, 4.0):
        np.testing.assert_array_equal(N(tbox.valid_box_mask(T(a), min_size)),
                                      N(jbox.valid_box_mask(a, min_size)))


@pytest.mark.parametrize("reg_dim", [4, 12])
def test_decode_boxes(reg_dim):
    rng = np.random.RandomState(1)
    rois = random_boxes(rng, 64, degenerate=False)
    deltas = rng.randn(64, reg_dim).astype(np.float32) * 2.0
    deltas[::5, 2] = 9.0  # beyond the wh_clip clamp
    stds = (0.1, 0.1, 0.2, 0.2)
    got = N(tbox.decode_boxes(T(rois), T(deltas), stds=stds))
    ref = N(jbox.decode_boxes(rois, deltas, stds=stds))
    # exp differs by an ulp between the two libraries; everything else is exact
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


def test_anchors_exact():
    gen_t = tanc.AnchorGenerator((4, 8, 16, 32, 64), (8.0,), (0.5, 1.0, 2.0))
    gen_j = janc.AnchorGenerator((4, 8, 16, 32, 64), (8.0,), (0.5, 1.0, 2.0))
    shapes = [(64, 80), (32, 40), (16, 20), (8, 10), (4, 5)]
    for got, ref in zip(gen_t.per_level(shapes), gen_j.per_level(shapes)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(N(got), N(ref))
    for legacy in (0.0, 1.0):
        np.testing.assert_array_equal(
            N(tanc.grid_anchors(5, 7, 16, (2.0, 4.0), (0.5, 1.0), legacy_offset=legacy)),
            N(janc.grid_anchors(5, 7, 16, (2.0, 4.0), (0.5, 1.0), legacy_offset=legacy)))


# ---------------------------------------------------------------- RoIAlign


STRIDES = (4, 8, 16, 32)


def pyramid(rng, c, b=2, base=(64, 48)):
    return [rng.randn(b, base[0] >> i, base[1] >> i, c).astype(np.float32) for i in range(4)]


def rois_for(rng, b, r, img_hw=(256, 192), overhang=True):
    side = np.exp(rng.uniform(2.0, 5.3, (b, r)))
    asp = np.exp(rng.randn(b, r) * 0.4)
    w, h = side * np.sqrt(asp), side / np.sqrt(asp)
    lo = -20.0 if overhang else 0.0
    cx = rng.uniform(lo, img_hw[1] - lo, (b, r))
    cy = rng.uniform(lo, img_hw[0] - lo, (b, r))
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if not overhang:
        rois = np.clip(rois, 0, [img_hw[1], img_hw[0], img_hw[1], img_hw[0]])
    return rois.astype(np.float32)


def test_fpn_level_assign_exact():
    rng = np.random.RandomState(2)
    rois = rois_for(rng, 1, 500)[0]
    rois[:5] = [[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448], [0, 0, 0, 0], [5, 5, 1, 1]]
    np.testing.assert_array_equal(
        N(tra.fpn_level_assign(T(rois), min_level=2, max_level=5)),
        N(jra.fpn_level_assign(rois, min_level=2, max_level=5)))


@pytest.mark.parametrize("output_size", [7, 14])
def test_roi_align_matches_jax(output_size):
    """Plain RoIAlign vs the JAX reference (per-image vmap) at 1e-5: rois over
    every level, overhanging every edge, invalid rows zeroed."""
    rng = np.random.RandomState(3)
    feats = pyramid(rng, 32)
    rois = rois_for(rng, 2, 60)
    valid = rng.rand(2, 60) > 0.2
    got = tra.multilevel_roi_align([T(f) for f in feats], T(rois), STRIDES,
                                   output_size=output_size, roi_valid=T(valid))
    ref = jax.vmap(lambda f, r, v: jra.multilevel_roi_align(
        f, r, STRIDES, output_size=output_size, roi_valid=v))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(valid))
    assert got.shape == (2, 60, output_size, output_size, 32)
    np.testing.assert_allclose(N(got), N(ref), rtol=0, atol=1e-5)
    assert float(got[torch.from_numpy(~valid)].abs().max()) == 0.0


def test_roi_align_matches_pallas_interpret():
    """Plain RoIAlign vs the Pallas kernel in interpret mode at 1e-5, C=128,
    rois inside the kernel's window coverage."""
    rng = np.random.RandomState(4)
    feats = pyramid(rng, 128, b=1)
    rois = rois_for(rng, 1, 24, overhang=False)
    got = tra.multilevel_roi_align([T(f) for f in feats], T(rois), STRIDES)[0]
    ref = multilevel_roi_align_pallas([jnp.asarray(f[0]) for f in feats], jnp.asarray(rois[0]),
                                      STRIDES, interpret=True)
    # the kernel contracts separable weight matrices instead of summing taps:
    # another association of the same f32 sums
    np.testing.assert_allclose(N(got), N(ref), rtol=1e-5, atol=1e-5)


def test_roi_align_dispatch():
    rng = np.random.RandomState(5)
    feats = [T(f) for f in pyramid(rng, 8, b=1)]
    rois = T(rois_for(rng, 1, 10))
    lv = tra.roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    torch.testing.assert_close(tra.multilevel_roi_align(feats, rois, STRIDES),
                               tra.multilevel_roi_align_plain(feats, rois, STRIDES, lv),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no implementation"):
        tra.multilevel_roi_align([f.to("meta") for f in feats], rois.to("meta"), STRIDES)


def _feats(c=8, dtype=torch.float32, n=4):
    return [torch.zeros(2, 16 >> i, 12 >> i, c, dtype=dtype) for i in range(n)]


def _roi_align_call(features=None, strides=STRIDES, levels=None, output_size=7):
    features = _feats() if features is None else features
    levels = torch.zeros(2, 5, dtype=torch.int32) if levels is None else levels
    return lambda: roi_align_cuda(features, torch.zeros(2, 5, 4), strides, levels,
                                  output_size=output_size)


def _nms_call(boxes):
    return lambda: nms_mask_sorted_cuda(boxes, torch.ones(boxes.shape[:2], dtype=torch.bool), 0.5)


WRAPPER_CASES = {
    "roi_align_dtype": (TypeError, "dtype", _roi_align_call(features=_feats(dtype=torch.float16))),
    "roi_align_wide_c": (ValueError, "C=2048", _roi_align_call(features=_feats(c=2048))),
    "roi_align_6_levels": (ValueError, "levels", _roi_align_call(features=_feats(n=6),
                                                                strides=(4,) * 6)),
    "roi_align_strides": (ValueError, "stride", _roi_align_call(strides=(4, 8))),
    "roi_align_samples": (ValueError, "<= 64", _roi_align_call(output_size=40)),
    "roi_align_layout": (ValueError, "contiguous", _roi_align_call(
        features=[f.permute(0, 2, 1, 3) for f in _feats()])),
    "roi_align_levels_shape": (ValueError, "levels", _roi_align_call(
        levels=torch.zeros(2, 4, dtype=torch.int32))),
    "roi_align_cpu": (ValueError, "CUDA", _roi_align_call()),
    "nms_shape": (ValueError, "boxes", _nms_call(torch.zeros(2, 8, 3))),
    "nms_too_many": (ValueError, "too large", _nms_call(torch.zeros(1, 64 * 6144 + 1, 4))),
    "nms_cpu": (ValueError, "CUDA", _nms_call(torch.zeros(2, 8, 4))),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_cuda_wrappers_validate_before_launch(case, monkeypatch):
    """The kernels' wrappers refuse what their kernels do not take, and any
    tensor not on a CUDA device, before building or launching anything."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cuda_roi_align, "load_library", no_build)
    monkeypatch.setattr(cuda_nms, "load_library", no_build)
    exc, match, call = WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        call()


# ---------------------------------------------------------------- NMS


def test_nms_fixture_matches_jax_and_pallas():
    d = np.load("tests/fixtures/nms.npz")
    boxes, scores, valid = (jnp.asarray(d[k]) for k in ("boxes", "scores", "valid"))
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(
            N(tnms.nms_mask(T(boxes), T(scores), thr, T(valid))),
            N(jnms.nms_mask(boxes, scores, thr, valid)))
        for max_out in (16, 100):
            got = tnms.nms(T(boxes), T(scores), thr, max_out, valid=T(valid))
            ref = jnms.nms(boxes, scores, thr, max_out, valid=valid)
            pal = nms_pallas(boxes, scores, thr, max_out, valid=valid, interpret=True)
            for g, r, p in zip(got, ref, pal):
                np.testing.assert_array_equal(N(g), N(r))
                np.testing.assert_array_equal(N(g), N(p))


def test_nms_ties_keep_lowest_index_first():
    """Equal scores (random-weight detectors score many boxes exactly 1.0):
    order, and so suppression, follows the lowest index, as in JAX."""
    rng = np.random.RandomState(6)
    boxes = random_boxes(rng, 96, degenerate=False)
    boxes[40:60] = boxes[20:40] + 1.0          # near-duplicates
    scores = np.where(rng.rand(96) > 0.3, 1.0, 0.5).astype(np.float32)
    for thr in (0.5, 0.7):
        got = tnms.nms(T(boxes), T(scores), thr, 50)
        ref = jnms.nms(boxes, scores, thr, 50)
        pal = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, 50, interpret=True)
        for g, r, p in zip(got, ref, pal):
            np.testing.assert_array_equal(N(g), N(r))
            np.testing.assert_array_equal(N(g), N(p))


def test_class_aware_nms_matches_jax_and_pallas():
    rng = np.random.RandomState(7)
    boxes = random_boxes(rng, 150, degenerate=False)
    scores = rng.rand(150).astype(np.float32)
    scores[::9] = 1.0
    labels = rng.randint(0, 5, 150)
    got = tnms.class_aware_nms(T(boxes), T(scores), T(labels), 0.5, 40, score_thr=0.05)
    ref = jnms.class_aware_nms(boxes, scores, labels, 0.5, 40, score_thr=0.05)
    pal = class_aware_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                 0.5, 40, score_thr=0.05, interpret=True)
    for g, r, p in zip(got, ref, pal):
        np.testing.assert_array_equal(N(g), N(r))
        np.testing.assert_array_equal(N(g), N(p))


def test_batched_nms_equals_per_problem():
    """One batched call (one kernel launch on the card) = vmapped JAX calls,
    including NaN-scrubbed per-problem class offsets over valid rows."""
    rng = np.random.RandomState(8)
    boxes = np.stack([random_boxes(rng, 80, degenerate=False) for _ in range(6)]).reshape(2, 3, 80, 4)
    scores = rng.rand(2, 3, 80).astype(np.float32)
    labels = rng.randint(0, 4, (2, 3, 80))
    valid = rng.rand(2, 3, 80) > 0.25
    boxes[~valid] = np.nan                       # padding rows with NaN coordinates
    got = tnms.class_aware_nms(T(boxes), T(scores), T(labels), 0.5, 30, valid=T(valid))
    ref = jax.vmap(jax.vmap(lambda b, s, l, v: jnms.class_aware_nms(b, s, l, 0.5, 30, valid=v)))(
        boxes, scores, labels, valid)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(N(g), N(r))
    got = tnms.nms(T(boxes), T(scores), 0.6, 30, valid=T(valid))
    ref = jax.vmap(jax.vmap(lambda b, s, v: jnms.nms(b, s, 0.6, 30, valid=v)))(boxes, scores, valid)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(N(g), N(r))


def test_nms_dispatch_and_unported_methods():
    with pytest.raises(RuntimeError, match="no implementation"):
        tnms.nms_mask_sorted(torch.zeros(1, 4, 4, device="meta"),
                             torch.ones(1, 4, dtype=torch.bool, device="meta"), 0.5)
    z = torch.zeros(1, 8, 4), torch.zeros(1, 8), torch.zeros(1, 8, dtype=torch.int64)
    # Soft-NMS and box voting are ported: on all-zero candidates they keep
    # nothing, as the JAX dispatch does
    for cfg in (EvalCfg(nms_method="soft_linear"), EvalCfg(bbox_vote=True)):
        got = tnms.class_aware_nms_from_cfg(cfg, *z)
        ref = jnms.class_aware_nms_from_cfg(cfg, *(np.asarray(x[0]) for x in z))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(N(g)[0], N(r))
        assert not N(got[3]).any()
    with pytest.raises(ValueError):
        tnms.class_aware_nms_from_cfg(EvalCfg(nms_method="median"), *z)


# ---------------------------------------------------------------- proposals


def test_generate_proposals_matches_jax():
    rng = np.random.RandomState(9)
    b, a = 2, 3
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    anchors = tanc.AnchorGenerator((4, 8, 16, 32, 64), (8.0,), (0.5, 1.0, 2.0)).per_level(shapes)
    cls = [rng.randn(b, h, w, a).astype(np.float32) for h, w in shapes]
    reg = [(rng.randn(b, h, w, 4 * a) * 0.3).astype(np.float32) for h, w in shapes]
    hw = np.asarray([[64.0, 80.0], [50.0, 70.0]], np.float32)
    # levels hold 960, 240, 60, 18 and 6 anchors: the last three are padded
    # to the common 200 candidates, and NMS leaves fewer than 400 proposals
    kw = dict(pre_nms_top_n=200, post_nms_top_n=400, nms_thr=0.5, bbox_stds=(1.0, 1.0, 1.0, 1.0))
    got = tprop.generate_proposals([T(c) for c in cls], [T(r) for r in reg], anchors, T(hw), **kw)
    ref = jprop.generate_proposals([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
                                   [jnp.asarray(N(x)) for x in anchors], jnp.asarray(hw), **kw)
    np.testing.assert_array_equal(N(got[2]), N(ref[2]))
    np.testing.assert_allclose(N(got[0]), N(ref[0]), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(N(got[1]), N(ref[1]))
    assert 0 < int(got[2].sum()) < got[2].numel()


# ---------------------------------------------------------------- transform


@pytest.mark.parametrize("case", ["downscale", "upscale", "flip"])
def test_batch_transform_matches_jax(case):
    rng = np.random.RandomState(10)
    raw_hw, out_hw, scale, max_size = {
        "downscale": ((120, 160), (64, 96), 60, 90),
        "upscale": ((40, 56), (96, 128), 80, 128),
        "flip": ((120, 160), (64, 96), 60, 90),
    }[case]
    raw = rng.randint(0, 256, (2, *raw_hw, 3)).astype(np.uint8)
    hw = np.asarray([[raw_hw[0], raw_hw[1]], [raw_hw[0] - 17, raw_hw[1] - 9]], np.float32)
    flip = np.asarray([case == "flip", False])
    gtb = (rng.rand(2, 5, 4) * 40).astype(np.float32)
    kw = dict(out_hw=out_hw, scale_size=scale, max_size=max_size,
              mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375))
    got = ttf.batch_transform(T(raw), T(hw), T(flip), T(gtb), dtype=torch.float32, **kw)
    ref = jtf.batch_transform(jnp.asarray(raw), jnp.asarray(hw), jnp.asarray(flip),
                              jnp.asarray(gtb), dtype=jnp.float32, **kw)
    for k in ("images", "gt_boxes", "im_info"):
        np.testing.assert_allclose(N(got[k]), N(ref[k]), rtol=0, atol=1e-4, err_msg=k)
