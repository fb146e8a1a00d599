"""Port parity, RetinaNet R50-FPN: the head, the conv P6/P7 of the FPN, the
focal loss, the anchors, both (anchor, class) top-k forms, the loss and the
postprocess of ``mxdetection_tpu_torch`` against the JAX package on the CPU
in float32, then the whole detector and one training step against the
frozen fixtures ``detector_retinanet_r50_fpn_1x.npz`` and
``trainstep_retinanet_r50_fpn_1x.npz`` (read only) from converted
``PRNGKey(7)`` variables. On the CPU the assigner and NMS run their plain
versions; ``chip_smoke.py`` holds K2 and K4 against those on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.losses import losses as jloss
from mxdetection_tpu.models.detectors import retinanet as jret
from mxdetection_tpu.models.heads.retina import RetinaHead as JRetinaHead
from mxdetection_tpu.models.necks.fpn import FPN as JFPN
from mxdetection_tpu.models.registry import build_detector as jax_build_detector

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.losses import losses as tloss
from mxdetection_tpu_torch.models.detectors import retinanet as tret
from mxdetection_tpu_torch.models.heads.retina import RetinaHead
from mxdetection_tpu_torch.models.necks.fpn import FPN
from mxdetection_tpu_torch.models.registry import build_detector, detector_fns
from mxdetection_tpu_torch.utils.convert import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_detector_fixtures as det_fx  # noqa: E402
import test_train_fixtures as train_fx  # noqa: E402
from test_torch_port_detector import assert_rel_close, init_flax  # noqa: E402
from test_torch_port_train import _grad_norm, one_torch_thread  # noqa: E402,F401

RETINA = "retinanet_r50_fpn_1x"
F32 = jnp.float32


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg(jax_side: bool, **over):
    """RetinaNet on a 64x80 canvas (P3-P7: 8x10 .. 1x1) with 5 classes."""
    load = jax_load_config if jax_side else load_config
    over = {"data.pad_h": 64, "data.pad_w": 80, "retina_head.num_classes": 5, **over}
    return load(os.path.join(REPO, f"configs/{RETINA}.py")).override(**over)


def level_shapes(hw=(64, 80)):
    return [(-(-hw[0] // 2 ** lv), -(-hw[1] // 2 ** lv)) for lv in range(3, 8)]


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("stacked_convs", [0, 2])
def test_retina_head_matches_flax(stacked_convs):
    """A 12 -> 16-channel head with 2 anchors of 3 classes over three levels
    (its convs shared by the levels), 1e-5 of the largest output; the
    seeded init gives ``cls_score`` the prior bias and normal(0.01) weights."""
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 8 >> i, 10 >> i, 12).astype(np.float32) for i in range(3)]
    jm = JRetinaHead(num_classes=3, num_anchors=2, stacked_convs=stacked_convs, channels=16,
                     dtype=F32)
    v = init_flax(jm, feats)
    # the flax init sets the prior bias; perturb it so a swapped bias shows
    v["params"]["bbox_pred"]["bias"] = rng.randn(8).astype(np.float32)
    m = load_flax_variables(RetinaHead(3, 2, stacked_convs, 16, in_channels=12), v)
    got = m([T(f) for f in feats])
    ref = jm.apply(v, feats)
    for gl, rl, width in zip(got, ref, (6, 8)):
        for g, r in zip(gl, rl):
            assert g.shape[-1] == width
            assert_rel_close(g, r, 1e-5)

    m.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(N(m.cls_score.bias), v["params"]["cls_score"]["bias"],
                               rtol=1e-6)
    assert abs(float(m.cls_score.bias.detach()[0]) + np.log(99.0)) < 1e-5
    assert abs(float(m.cls_score.weight.detach().std()) / 0.01 - 1) < 0.1


def test_fpn_conv_p6_p7_matches_flax():
    """``extra_convs="conv"``: P6 a 3x3 stride-2 conv of C5 (its 32 input
    channels, not P5's 16), P7 one of ReLU(P6), on a 32x40 C2 (P7 of odd
    sides); the levels' shapes and values (1e-5 of the largest) as flax's."""
    rng = np.random.RandomState(4)
    widths = (8, 16, 24, 32)
    feats = [rng.randn(2, 32 >> i, 40 >> i, c).astype(np.float32) for i, c in enumerate(widths)]
    jm = JFPN(out_channels=16, min_level=3, max_level=7, extra_convs="conv", dtype=F32)
    v = init_flax(jm, feats)
    assert set(v["params"]) == {"lateral_p3", "lateral_p4", "lateral_p5", "smooth_p3",
                                "smooth_p4", "smooth_p5", "extra_p6", "extra_p7"}
    m = load_flax_variables(FPN(out_channels=16, min_level=3, max_level=7, extra_convs="conv",
                                in_channels=widths), v)
    got = m([T(f) for f in feats])
    ref = jm.apply(v, feats)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert [r.shape[1:3] for r in ref] == [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    for g, r in zip(got, ref):
        assert_rel_close(g, r, 1e-5)


def test_sigmoid_focal_loss_matches_jax():
    """Elementwise values and the gradient of their sum at logits up to
    +-40 (where the log-sigmoid form matters): 1e-6 relative to the
    largest, as both take the same f32 terms."""
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 300) * 8).astype(np.float32)
    x[0, :6] = [-40.0, -20.0, 0.0, 20.0, 40.0, 1e-3]
    t = (rng.rand(6, 300) < 0.2).astype(np.float32)
    xt = T(x).requires_grad_()
    got = tloss.sigmoid_focal_loss(xt, T(t), alpha=0.25, gamma=2.0)
    got.sum().backward()
    ref = jloss.sigmoid_focal_loss(x, t, alpha=0.25, gamma=2.0)
    gref = jax.grad(lambda z: jloss.sigmoid_focal_loss(z, t).sum())(x)
    assert np.isfinite(N(got)).all() and np.isfinite(N(xt.grad)).all()
    assert_rel_close(got, ref, 1e-6)
    assert_rel_close(xt.grad, gref, 1e-6)


@pytest.mark.parametrize("hw", [(256, 320), (250, 333)])
def test_make_anchors_match_jax(hw):
    """Every level's anchors (scales 4 * 2^(i/3), ratios 0.5 / 1 / 2) equal
    the JAX ``make_anchors``', on a canvas that divides by 128 and one that
    does not."""
    got = tret.make_anchors(load_config(RETINA), hw)
    ref = jret.make_anchors(jax_load_config(os.path.join(REPO, f"configs/{RETINA}.py")), hw)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(N(got), N(ref))


def tied_logits(rng, b, a, c, dtype=np.float32):
    """Logits in 1/8 steps of a narrow range: most (anchor, class) pairs tie
    with many others, at the anchor cut too; some rows share their best."""
    x = np.round(rng.randn(b, a, c) * 2.0) / 8.0
    x[:, 5:40] = x[:, 5:6]          # whole rows equal
    x[:, :, 3] = np.maximum(x[:, :, 3], 0.5)
    return x.astype(dtype)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_pairs_match_jax_on_ties(exact, dtype):
    """Both top-k forms on heavily tied logits (3 images x 300 anchors x 7
    classes, k = 50 and 400): scores, anchor and class indices equal to the
    JAX function's, image by image, in f32 and bf16 (the anchor stage takes
    the max in the logits' dtype, as JAX does)."""
    rng = np.random.RandomState(2)
    x = tied_logits(rng, 3, 300, 7)
    tx = T(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    tfn, jfn = ((tret.topk_pairs_exact, jret.topk_pairs_exact) if exact
                else (tret.topk_pairs, jret.topk_pairs))
    for k in (50, 400):
        got = tfn(tx, k, 7)
        for i in range(3):
            ref = jfn(jx[i], k, 7)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(N(g[i]), N(r))


def random_outputs(rng, b, hw, num_classes, ties: bool):
    """Per-level NHWC cls logits (9 anchors a cell) and reg deltas."""
    cls, reg = [], []
    for h, w in level_shapes(hw):
        x = (tied_logits(rng, b, h * w * 9, num_classes) if ties
             else rng.randn(b, h * w * 9, num_classes).astype(np.float32) * 3.0)
        cls.append(x.reshape(b, h, w, 9 * num_classes))
        reg.append((rng.randn(b, h, w, 36) * 0.5).astype(np.float32))
    return cls, reg


@pytest.mark.parametrize("exact", [False, True])
def test_postprocess_matches_jax_on_ties(exact):
    """``retinanet_postprocess`` on tied logits (2 images, 64x80, 5
    classes, ``pre_nms_per_class`` 60 so the merged cap cuts), both top-k
    forms: valid and labels equal, boxes within 1e-4 px and scores 1e-6 of
    the JAX function's."""
    rng = np.random.RandomState(3)
    over = {"test.exact_topk": exact, "test.pre_nms_per_class": 60, "test.max_per_image": 60,
            "test.score_thr": 0.3}
    tcfg, jcfg = small_cfg(False, **over), small_cfg(True, **over)
    cls, reg = random_outputs(rng, 2, (64, 80), 5, ties=True)
    im_info = np.asarray([[60.0, 70.0, 1.0], [40.0, 50.0, 0.8]], np.float32)
    got = tret.retinanet_postprocess({"cls": [T(c) for c in cls], "reg": [T(r) for r in reg]},
                                     tcfg, (64, 80), T(im_info))
    ref = jret.retinanet_postprocess({"cls": cls, "reg": reg}, jcfg, (64, 80), im_info)
    np.testing.assert_array_equal(N(got["valid"]), N(ref["valid"]))
    np.testing.assert_array_equal(N(got["labels"]), N(ref["labels"]))
    np.testing.assert_allclose(N(got["boxes"]), N(ref["boxes"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(got["scores"]), N(ref["scores"]), rtol=0, atol=1e-6)
    assert 10 < int(N(got["valid"]).sum()) < 120  # NMS and the threshold cut


def test_retinanet_loss_matches_jax():
    """``retinanet_loss`` on a tiny batch (3 images on a 64x80 canvas, 5
    classes; one image without gt, one with duplicated gt) against the JAX
    loss: total and metrics 1e-6 relative, the gradients of the total with
    respect to the per-level logits and deltas 1e-5 of the largest."""
    rng = np.random.RandomState(5)
    tcfg, jcfg = small_cfg(False), small_cfg(True)
    cls, reg = random_outputs(rng, 3, (64, 80), 5, ties=False)
    gt = np.zeros((3, 4, 4), np.float32)
    gt[0, :3] = [[4, 6, 30, 40], [20, 10, 60, 50], [50, 2, 78, 20]]
    gt[1, :2] = [[10, 10, 40, 30], [10, 10, 40, 30]]
    valid = np.zeros((3, 4), bool)
    valid[0, :3] = valid[1, :2] = True
    labels = rng.randint(0, 5, (3, 4)).astype(np.int32)

    tcls = [T(c).requires_grad_() for c in cls]
    treg = [T(r).requires_grad_() for r in reg]
    tb = {"gt_boxes": T(gt), "gt_labels": T(labels), "gt_valid": T(valid)}
    loss, metrics = tret.retinanet_loss({"cls": tcls, "reg": treg, "pad_hw": (64, 80)}, tb,
                                        None, tcfg)
    loss.backward()

    anchors = jret.make_anchors(jcfg, (64, 80))

    def jloss_fn(c, r):
        return jret.retinanet_loss({"cls": c, "reg": r}, anchors, gt, labels, valid, None, jcfg)

    (ref, jmetrics), grads = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(cls, reg)
    assert abs(float(loss.detach()) - float(ref)) <= 1e-6 * abs(float(ref))
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        r = float(jmetrics[k])
        assert abs(float(metrics[k].detach()) - r) <= 1e-6 * max(abs(r), 1.0), k
    assert float(metrics["num_pos"]) > 1
    for g, r in zip([t.grad for t in tcls + treg], list(grads[0]) + list(grads[1])):
        assert_rel_close(g, r, 1e-5)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def retina_variables():
    """The JAX ``PRNGKey(7)`` variables of both RetinaNet fixtures (one
    tree: the detector and the train-step shrink differ in no parameter),
    jitted, as numpy."""
    jcfg = train_fx.shrink(jax_load_config(os.path.join(REPO, f"configs/{RETINA}.py")))
    tb = train_fx.synthetic_batch(jcfg)
    bundle = jax_build_detector(jcfg)
    return jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb)), tb


def test_detector_reproduces_retinanet_fixture(retina_variables):
    """Converted ``PRNGKey(7)`` params reproduce
    ``detector_retinanet_r50_fpn_1x.npz`` through ``forward_test`` and the
    registry's postprocess, the two-stage top-k: scores, labels and valid
    at rtol/atol 1e-4, boxes at an absolute 0.05 px (the Faster fixture's
    bounds and reason; measured: boxes within 7.3e-4 px, scores 2.4e-7)."""
    variables, _ = retina_variables
    cfg = det_fx.shrink(load_config(RETINA))
    images = np.asarray(det_fx.synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[det_fx.HW[0], det_fx.HW[1], 1.0]], np.float32)
    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    out = model.forward_test(T(images), T(im_info))
    assert [tuple(c.shape[1:3]) for c in out["cls"]] == level_shapes(det_fx.HW)
    dets = detector_fns(cfg).postprocess(out, cfg, det_fx.HW, T(im_info))

    ref = np.load(os.path.join(REPO, f"tests/fixtures/detector_{RETINA}.npz"))
    v = N(dets["valid"][0])
    got = {"boxes": N(dets["boxes"][0]) * v[:, None], "scores": N(dets["scores"][0]) * v,
           "labels": N(dets["labels"][0]) * v, "valid": v.astype(np.int32)}
    for k in ("scores", "labels", "valid"):
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k].astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
    assert v.sum() == 20


def test_train_step_reproduces_retinanet_fixture(retina_variables):
    """One forward (``forward_train``) + the registry's loss + backward from
    the converted variables on the fixture's batch reproduces
    ``trainstep_retinanet_r50_fpn_1x.npz`` at the Faster train fixture's
    bounds: 2e-5 relative on the losses, 6e-5 on the grad norms, num_pos
    exact (measured on the CPU: losses within 8.3e-6, grad norms 7.5e-6).
    The loss draws nothing, so ``draws`` is None."""
    variables, tb = retina_variables
    cfg = train_fx.shrink(load_config(RETINA))
    model = load_flax_variables(build_detector(cfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    out = model.forward_train(ttb, None)
    loss, metrics = detector_fns(cfg).loss(out, ttb, None, cfg)
    loss.backward()

    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    for mod in ("backbone", "fpn", "head"):
        got[f"gnorm_{mod}"] = _grad_norm(getattr(model, mod).parameters())
    ref = np.load(os.path.join(REPO, f"tests/fixtures/trainstep_{RETINA}.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k == "metric_num_pos":
            assert got[k] == r, k
        else:
            rtol = 6e-5 if "norm" in k else 2e-5
            assert abs(got[k] - r) <= rtol * abs(r), (k, got[k], r)


def test_retinanet_defaults_to_the_card():
    """``build_detector`` and ``Trainer`` build RetinaNet on the card unless
    asked for the CPU: here, without one, they raise. On the CPU the model
    has the zoo's widths (720 class logits a cell, P6 from the 2048-wide
    C5), stored in the compute dtype at ``train=False``, f32 at ``train=True``."""
    from mxdetection_tpu_torch.train.trainer import Trainer

    cfg = load_config(RETINA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_detector(cfg, device="cpu")
    assert model.head.cls_score.weight.shape == (720, 256, 3, 3)
    assert model.head.bbox_pred.weight.shape == (36, 256, 3, 3)
    assert model.fpn.extra_p6.weight.shape == (256, 2048, 3, 3)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in build_detector(cfg, device="cpu", train=True).parameters()} == {
        torch.float32}
