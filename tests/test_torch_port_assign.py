"""Port parity, the max-IoU assigner (K4's route) on the CPU.

The card runs the assigner as two kernel passes that never write the IoU
matrix (``csrc/iou.cu``); their plain version, and the CPU path, is the
dense form ``ops/matching.py::assign_max_iou_dense``. Here the CPU path is
held bit for bit against the JAX package's ``assign_max_iou`` on both of its
branches (dense, and the ``lax.map`` over chunks, whose two-pass schedule
the kernels follow) on awkward inputs: padded gt, duplicated gt (argmax
ties), two gt sharing their best box (the last-gt rule), an image without
gt, ``box_valid``, IoUs exactly at the thresholds in f32, NaN and infinite
boxes, ``match_low_quality`` on and off, ``min_pos_iou`` > 0, and shapes
from one box or one gt up. The variant tools' edits must still find their
anchors in the kernel sources.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mxdetection_tpu.ops import matching as jmatch

from mxdetection_tpu_torch.ops import matching as tmatch
from mxdetection_tpu_torch.ops.cuda import k1_variants, k2_variants, k4_variants
from mxdetection_tpu_torch.ops.cuda.build import CSRC_DIR
from mxdetection_tpu_torch.ops.cuda.variants import copy_with_edits

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assign_case(n: int = 700, g: int = 12, seed: int = 0):
    """(anchors (n, 4), gt (4, g, 4), gt_valid (4, g), box_valid (4, n)):
    image 0 padded gt rows; image 1 duplicated gt rows and two gt sharing
    their best anchor; image 2 no valid gt; image 3 boxes with IoU exactly
    f32(0.7) and f32(0.3) against a gt, and a NaN and an infinite gt."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 300, (n, 2))
    wh = np.exp(rng.uniform(1.5, 4.5, (n, 2)))
    anchors = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    anchors[5] = [0.0, 0.0, 10.0, 7.0]     # IoU 70/100 with gt [0, 0, 10, 10]
    anchors[6] = [0.0, 0.0, 10.0, 3.0]     # IoU 30/100
    anchors[7] = anchors[8]                # two boxes tying for every gt
    anchors[9::50] = 0.0                   # zero-area rows
    xy = rng.uniform(0, 280, (4, g, 2))
    gt = np.concatenate([xy, xy + np.exp(rng.uniform(2.0, 4.5, (4, g, 2)))], -1).astype(np.float32)
    valid = np.ones((4, g), bool)
    valid[0, ::3] = False
    gt[0, ::3] = 0.0
    gt[1, 6:9] = gt[1, 2:5]                # duplicates
    a = anchors[100]
    gt[1, 9] = a + [-2.0, -2.0, 2.0, 2.0]  # one best anchor for gt 9 and 10
    gt[1, 10] = a + [2.0, 2.0, -2.0, -2.0]
    valid[2] = False
    gt[3, 0] = [0.0, 0.0, 10.0, 10.0]
    gt[3, 1] = [np.nan, 0.0, 10.0, 10.0]
    gt[3, 2] = [0.0, 0.0, np.inf, 10.0]
    box_valid = rng.rand(4, n) > 0.15
    return anchors, gt, valid, box_valid


def assert_same(got, ref):
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(N(x), N(y))


def hold_against_jax(got, anchors, gt, valid, box_valid, jax_chunk, **kw):
    for i in range(gt.shape[0]):
        ref = jmatch.assign_max_iou(anchors, gt[i], valid[i], box_valid=box_valid[i],
                                    chunk=jax_chunk, **kw)
        np.testing.assert_array_equal(N(got.labels[i]), N(ref.labels))
        np.testing.assert_array_equal(N(got.matched_gt[i]), N(ref.matched_gt))
        np.testing.assert_array_equal(N(got.max_iou[i]), N(ref.max_iou))


@pytest.mark.parametrize("low_quality,min_pos_iou", [(True, 0.0), (True, 0.3), (False, 0.0)])
@pytest.mark.parametrize("jax_chunk", [16384, 64])
def test_assign_matches_jax(low_quality, min_pos_iou, jax_chunk):
    """The CPU assigner against the JAX assigner per image: its dense
    branch (n <= 2 * chunk) and its ``lax.map`` branch (chunks of 64 rows),
    bit for bit."""
    anchors, gt, valid, box_valid = assign_case()
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=min_pos_iou,
              match_low_quality=low_quality)
    got = tmatch.assign_max_iou(T(anchors).expand(4, *anchors.shape), T(gt), T(valid),
                                box_valid=T(box_valid), **kw)
    hold_against_jax(got, anchors, gt, valid, box_valid, jax_chunk, **kw)
    labels, matched = N(got.labels), N(got.matched_gt)
    assert labels[3, 5] in (1, -2) and labels[3, 6] in (-1, -2)  # f32 thresholds
    assert set(labels[2]) <= {0, -2}
    if low_quality and min_pos_iou == 0.0:
        assert matched[1, 100] == 10          # the last gt of a shared best anchor


@pytest.mark.parametrize("n,g,seed", [(1, 1, 0), (1, 5, 1), (64, 1, 2), (65, 3, 3),
                                      (129, 100, 4), (300, 37, 5), (257, 64, 6), (200, 8, 7)])
def test_assign_matches_jax_shapes(n, g, seed):
    """Shapes from one box or one gt up, around the JAX branch's chunk of 64
    rows, with gt made from jittered boxes (many overlaps and ties) and a
    random valid mask: the CPU assigner against both JAX branches, with the
    low-quality force and ``min_pos_iou`` > 0."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (n, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 40, (n, 2))], 1).astype(np.float32)
    pick = rng.randint(0, n, (2, g))
    gt = (anchors[pick] + rng.randint(-2, 3, (2, g, 4))).astype(np.float32)
    valid = rng.rand(2, g) > 0.2
    box_valid = rng.rand(2, n) > 0.1
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.1, match_low_quality=True)
    got = tmatch.assign_max_iou(T(anchors).expand(2, n, 4), T(gt), T(valid),
                                box_valid=T(box_valid), **kw)
    for jax_chunk in (16384, 32):
        hold_against_jax(got, anchors, gt, valid, box_valid, jax_chunk, **kw)


def test_iou_is_never_nan_and_ties_go_first():
    """What the kernel relies on: the masked IoU holds no NaN even for NaN
    and infinite boxes (the bits of non-negative IoUs order as the floats);
    the row max goes to the first of tied gt."""
    anchors, gt, valid, _ = assign_case()
    anchors[10] = [np.nan, 1.0, 5.0, 5.0]
    anchors[11] = [-np.inf, -np.inf, np.inf, np.inf]
    iou = tmatch.masked_iou(T(anchors).expand(4, *anchors.shape), T(gt), T(valid))
    assert not torch.isnan(iou).any()
    m, a = tmatch.max_iou_rows(T(anchors).expand(4, *anchors.shape), T(gt), T(valid))
    np.testing.assert_array_equal(N(m), N(iou.max(-1).values))
    np.testing.assert_array_equal(N(a), N(iou.max(-1).indices))
    dup = N(a[1])[N(m[1]) > 0]
    assert np.isin(dup, [2, 3, 4]).any() and not np.isin(dup, [6, 7, 8]).any()
    np.testing.assert_array_equal(N(m[2]), -1.0)
    np.testing.assert_array_equal(N(a[2]), 0)


def test_assign_dispatches_by_device():
    """The CPU takes the dense route; a device without an implementation
    raises, for both entry points."""
    anchors, gt, valid, box_valid = assign_case(n=200)
    boxes = T(anchors).expand(4, *anchors.shape)
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, box_valid=T(box_valid))
    assert_same(tmatch.assign_max_iou(boxes, T(gt), T(valid), **kw),
                tmatch.assign_max_iou_dense(boxes, T(gt), T(valid), **kw))
    assert_same(tmatch.max_iou_rows(boxes, T(gt), T(valid)),
                tmatch.masked_iou(boxes, T(gt), T(valid)).max(-1))
    meta = [t.to("meta") for t in (boxes, T(gt), T(valid))]
    with pytest.raises(RuntimeError, match="no implementation"):
        tmatch.assign_max_iou(*meta, pos_iou_thr=0.7, neg_iou_thr=0.3)
    with pytest.raises(RuntimeError, match="no implementation"):
        tmatch.max_iou_rows(*meta)


VARIANT_EDITS = [("k1", name) for name in k1_variants.VARIANTS] + \
    [("k2", name) for name in k2_variants.VARIANTS] + \
    [("k4", name) for name in k4_variants.VARIANTS]


@pytest.mark.parametrize("tool,name", VARIANT_EDITS)
def test_variant_edits_apply(tool, name, tmp_path):
    """Each variant of ``k1_variants``, ``k2_variants`` and ``k4_variants``
    finds every text it edits exactly once in the kernel's source, and
    changes it."""
    mod = {"k1": k1_variants, "k2": k2_variants, "k4": k4_variants}[tool]
    csrc = copy_with_edits(CSRC_DIR, str(tmp_path / name), mod.SOURCE, mod.VARIANTS[name])
    with open(os.path.join(csrc, mod.SOURCE)) as f:
        edited = f.read()
    with open(os.path.join(CSRC_DIR, mod.SOURCE)) as f:
        assert (edited == f.read()) == (not mod.VARIANTS[name])
