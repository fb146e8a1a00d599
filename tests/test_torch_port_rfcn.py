"""Port parity, R-FCN R50 (dilated C5, deformable PSRoIPool, OHEM): the
dilated stage 4, the RPN head on a wider input, ``psroi_pool`` plain and
deformable (values and gradients), ``ohem_select``, the OHEM branch of
``rcnn_loss`` and the single-level proposals at R-FCN's 6000 of 52,416
anchors, against the JAX package on the CPU in float32; then the whole
detector and one training step against the frozen fixtures
``detector_rfcn_r50_1x.npz`` and ``trainstep_rfcn_r50_1x.npz`` (read only)
from converted ``PRNGKey(7)`` variables and the JAX draws (``jax_draws``).
On the CPU NMS and the assigner run their plain versions; ``chip_smoke.py``
holds K2 and K4 against those on the card.
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
from mxdetection_tpu.models import layers as jlayers
from mxdetection_tpu.models.backbones.resnet import Bottleneck as JBottleneck
from mxdetection_tpu.models.backbones.resnet import ResNet as JResNet
from mxdetection_tpu.models.detectors import rcnn as jrcnn
from mxdetection_tpu.models.heads.rpn import RPNHead as JRPNHead
from mxdetection_tpu.models.registry import build_detector as jax_build_detector
from mxdetection_tpu.ops import proposals as jprop
from mxdetection_tpu.ops import psroi as jpsroi

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.losses import losses as tloss
from mxdetection_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from mxdetection_tpu_torch.models.detectors import rcnn as trcnn
from mxdetection_tpu_torch.models.heads.rpn import RPNHead
from mxdetection_tpu_torch.models.registry import build_detector, detector_fns
from mxdetection_tpu_torch.ops import proposals as tprop
from mxdetection_tpu_torch.ops import psroi as tpsroi
from mxdetection_tpu_torch.utils.convert import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_detector_fixtures as det_fx  # noqa: E402
import test_train_fixtures as train_fx  # noqa: E402
from test_torch_port_detector import assert_rel_close, init_flax  # noqa: E402
from test_torch_port_train import _grad_norm, jax_draws, one_torch_thread  # noqa: E402,F401

RFCN = "rfcn_r50_1x"
F32 = jnp.float32


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cfgs(**over):
    """(port, JAX) configs of R-FCN with the overrides."""
    return (load_config(RFCN).override(**over),
            jax_load_config(os.path.join(REPO, f"configs/{RFCN}.py")).override(**over))


# ---------------------------------------------------------------- backbone and RPN


def test_dilated_bottleneck_matches_flax():
    """A stride-1, dilation-2 block (padding 2) with its projection, as the
    first block of a dilated stage 4, 1e-5 of the largest output."""
    x = np.random.RandomState(2).randn(2, 9, 11, 8).astype(np.float32)
    jm = JBottleneck(channels=4, stride=1, dilation=2,
                     norm=jlayers.make_norm("frozen_bn", dtype=F32), dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(Bottleneck(8, 4, 1, dilation=2), v)
    assert m.conv2.dilation == (2, 2) and m.conv2.padding == (2, 2)
    assert_rel_close(m(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), jm.apply(v, x), 1e-5)


def test_resnet50_dilated_c5_matches_flax():
    """ResNet-50 with ``dilated_c5`` on a 48x80 image: C4 and C5 both at
    stride 16 (3x5), stage 4's first projection a stride-1 1x1, every map
    within 1e-4 of the largest of flax's."""
    x = np.random.RandomState(3).randn(1, 48, 80, 3).astype(np.float32)
    jm = JResNet(depth=50, dilated_c5=True, train=False, dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(ResNet(depth=50, dilated_c5=True), v)
    assert m.layer4_block0.downsample_conv.stride == (1, 1)
    assert {getattr(m, f"layer4_block{b}").conv2.dilation for b in range(3)} == {(2, 2)}
    with torch.no_grad():
        got = m(T(x))
    ref = jm.apply(v, x)
    assert [tuple(g.shape[1:3]) for g in got] == [(12, 20), (6, 10), (3, 5), (3, 5)]
    for g, r in zip(got, ref):
        assert_rel_close(g, r, 1e-4)


def test_rpn_head_reads_a_wider_input():
    """``RPNHead(in_channels=24, channels=16)``, as R-FCN's 512-wide head on
    the 1024-wide C4: 1e-5 of the largest output of flax's."""
    x = [np.random.RandomState(5).randn(2, 6, 7, 24).astype(np.float32)]
    jm = JRPNHead(num_anchors=12, channels=16, dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(RPNHead(12, 16, in_channels=24), v)
    assert m.rpn_conv.weight.shape == (16, 24, 3, 3)
    for gl, rl in zip(m([T(f) for f in x]), jm.apply(v, x)):
        for g, r in zip(gl, rl):
            assert_rel_close(g, r, 1e-5)


# ---------------------------------------------------------------- PSRoIPool


def psroi_case(rng, b=2, r=30, h=9, w=11, p=3, c=5, stride=4):
    """A (B, H, W, p*p*c) map and rois of every awkward kind: inside, across
    the edges, past the map, under a cell (width clamped to 1), inverted,
    padding; every 7th row invalid; offsets of std 3 (trans_std 0.1 shifts
    a bin by 0.3 of the roi), some at +-12, whose samples leave [-1, size]."""
    feat = rng.randn(b, h, w, p * p * c).astype(np.float32)
    xy = rng.uniform(-12, stride * w + 4, (b, r, 2))
    wh = rng.uniform(0.5, 30, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [-20.0, -20.0, -5.0, -4.0]
    rois[:, 1] = [30.0, 20.0, 31.0, 20.5]
    rois[:, 2] = [0.0, 0.0, 0.0, 0.0]
    rois[:, 3] = [10.0, 10.0, 4.0, 6.0]
    valid = np.ones((b, r), bool)
    valid[:, ::7] = False
    offsets = (rng.randn(b, r, p, p, 2) * 3.0).astype(np.float32)
    offsets[:, 4:8] = rng.choice([-12.0, 12.0], (b, 4, p, p, 2))
    return feat, rois, valid, offsets


@pytest.mark.parametrize("deform", [False, True])
def test_psroi_pool_matches_jax_gather(deform):
    """``psroi_pool`` (B=2, 30 rois, 3x3 bins of 5 channels, 2x2 samples)
    against the JAX ``impl="gather"`` image by image in f32: the pooled
    values within 1e-6 of the largest, and the vjp of a random cotangent
    with respect to the map (an index_add of autograd here, XLA's
    scatter-add there) and the offsets within 1e-5 of the largest."""
    rng = np.random.RandomState(6)
    feat, rois, valid, offsets = psroi_case(rng)
    cot = rng.randn(2, 30, 3, 3, 5).astype(np.float32)
    tf = T(feat).requires_grad_()
    to = T(offsets).requires_grad_() if deform else None
    got = tpsroi.psroi_pool(tf, T(rois), 4, output_size=3, offsets=to, trans_std=0.1,
                            roi_valid=T(valid))
    (got * T(cot)).sum().backward()
    assert got.shape == (2, 30, 3, 3, 5) and np.abs(N(got[:, ::7])).max() == 0.0
    for i in range(2):
        def pool(f, o):
            return jpsroi.psroi_pool(f, rois[i], 4, output_size=3, offsets=o, trans_std=0.1,
                                     roi_valid=valid[i], impl="gather")
        ref, vjp = jax.vjp(pool, feat[i], offsets[i] if deform else None)
        g_feat, g_off = vjp(cot[i])
        assert_rel_close(got[i], ref, 1e-6)
        assert_rel_close(tf.grad[i], g_feat, 1e-5)
        if deform:
            assert_rel_close(to.grad[i], g_off, 1e-5)
            assert float(np.abs(N(to.grad[i])).max()) > 0.0


def test_psroi_pool_bf16_within_its_rounding():
    """bf16 maps (deformable, f32 offsets): within 2^-6 of the largest value
    of the JAX gather in bf16 (the two round the four weighted corners'
    products and sums in bf16 at different points) and of the port's own f32
    pool of the same bf16-rounded map. The bf16 path is tested here alone:
    the fixtures are f32."""
    rng = np.random.RandomState(7)
    feat, rois, valid, offsets = psroi_case(rng)
    fb = T(feat).to(torch.bfloat16)
    got = tpsroi.psroi_pool(fb, T(rois), 4, output_size=3, offsets=T(offsets),
                            roi_valid=T(valid))
    f32 = tpsroi.psroi_pool(fb.float(), T(rois), 4, output_size=3, offsets=T(offsets),
                            roi_valid=T(valid))
    assert got.dtype == torch.bfloat16
    bound = 2.0 ** -6 * float(f32.abs().max())
    assert float((got.float() - f32).abs().max()) <= bound
    for i in range(2):
        ref = jpsroi.psroi_pool(jnp.asarray(feat[i], jnp.bfloat16), rois[i], 4, output_size=3,
                                offsets=offsets[i], roi_valid=valid[i], impl="gather")
        assert ref.dtype == jnp.bfloat16
        assert float(np.abs(N(got[i]) - np.asarray(ref, np.float32)).max()) <= bound


# ---------------------------------------------------------------- OHEM


def tied_losses(rng, b, n):
    """Per-roi losses in steps of 0.25 (many ties), 0 at invalid rows."""
    loss = np.round(rng.rand(b, n) * 12) / 4
    valid = rng.rand(b, n) < 0.8
    return np.where(valid, loss, 0.0).astype(np.float32), valid


def test_ohem_select_matches_jax_on_ties():
    """The hardest-``keep`` mask on tied losses (3 x 64 rows, steps of
    0.25, a fifth invalid) equals the JAX ``ohem_select``'s for keep 0, 1,
    16, 40 and past the valid count: of equal losses the lower index is
    kept first."""
    loss, valid = tied_losses(np.random.RandomState(8), 3, 64)
    for keep in (0, 1, 16, 40, 100):
        got = N(tloss.ohem_select(T(loss), T(valid), keep))
        for i in range(3):
            ref = jloss.ohem_select(loss[i], valid[i], keep)
            np.testing.assert_array_equal(got[i], np.asarray(ref))
            assert got[i].sum() == min(keep, valid[i].sum())


def test_rcnn_loss_ohem_matches_jax():
    """``rcnn_loss`` with ``bbox_head.ohem`` (keep 8 of 24 rois, whose
    rows repeat so their losses tie) on R-FCN's single-level RPN over a
    64x80 canvas (240 anchors) against the JAX loss with the same draws:
    the total and every metric within 1e-6 relative, the gradients with
    respect to the stage's logits and deltas within 1e-6 of the largest
    (only kept rows get one)."""
    rng = np.random.RandomState(9)
    b, s, nc1 = 2, 24, 81
    tcfg, jcfg = cfgs(**{"data.pad_h": 64, "data.pad_w": 80, "bbox_head.ohem_keep": 8})
    rpn_cls = [rng.randn(b, 4, 5, 12).astype(np.float32)]
    rpn_reg = [(rng.randn(b, 4, 5, 48) * 0.3).astype(np.float32)]
    cls = rng.randn(b, s, nc1).astype(np.float32) * 2
    deltas = rng.randn(b, s, 4).astype(np.float32)
    labels = rng.randint(-1, 6, (b, s)).astype(np.int32)
    tgt = rng.randn(b, s, 4).astype(np.float32)
    for a in (cls, deltas, labels, tgt):
        a[:, 12:18] = a[:, 6:12]        # equal rows: tied per-roi losses
    valid, pos = labels >= 0, labels > 0
    gt = np.asarray([[[5, 5, 40, 30], [30, 20, 70, 60]], [[10, 8, 50, 50], [0, 0, 0, 0]]],
                    np.float32)
    tb = {"gt_boxes": gt, "gt_valid": np.asarray([[True, True], [True, False]]),
          "im_info": np.asarray([[60.0, 75.0, 1.0], [64.0, 80.0, 1.0]], np.float32)}
    stage = {"labels": labels, "reg_targets": tgt, "pos": pos, "valid": valid}

    tcls, tdel = T(cls).requires_grad_(), T(deltas).requires_grad_()
    tout = {"rpn_cls": [T(x) for x in rpn_cls], "rpn_reg": [T(x) for x in rpn_reg],
            "pad_hw": (64, 80),
            "stages": [{"cls_logits": tcls, "deltas": tdel,
                        **{k: T(v) for k, v in stage.items()}}]}
    rng_key = jax.random.PRNGKey(3)
    loss, metrics = trcnn.rcnn_loss(tout, {k: T(v) for k, v in tb.items()}, jax_draws(rng_key),
                                    tcfg)
    loss.backward()

    def jfn(c, d):
        out = {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "pad_hw": (64, 80),
               "stages": [{"cls_logits": c, "deltas": d, **stage}]}
        return jrcnn.rcnn_loss(out, tb, rng_key, jcfg)

    (ref, jmetrics), (g_cls, g_del) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        cls, deltas)
    assert abs(float(loss.detach()) - float(ref)) <= 1e-6 * abs(float(ref))
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        r = float(jmetrics[k])
        assert abs(float(metrics[k].detach()) - r) <= 1e-6 * max(abs(r), 1.0), k
    kept_rows = (np.abs(N(tcls.grad)).sum(-1) > 0).sum(-1)
    assert list(kept_rows) == [8, 8]
    assert_rel_close(tcls.grad, g_cls, 1e-6)
    assert_rel_close(tdel.grad, g_del, 1e-6)


# ---------------------------------------------------------------- proposals


def test_single_level_proposals_at_rfcn_shape():
    """R-FCN's RPN anchors at 832x1344 are one level of 52 x 84 x 12 =
    52,416; ``generate_proposals`` takes its top 6000 to one NMS problem of
    N = 6000 (IoU 0.7) and keeps 300, as the JAX function does on the same
    logits (quantized, so many tie): the scores and valid equal, the rois
    within 1e-3 px (an ulp of the decode's exp at 1e3 px differs between
    the two libraries)."""
    tcfg, jcfg = cfgs()
    anchors = trcnn.rpn_level_anchors(tcfg, (832, 1344))
    assert [tuple(a.shape) for a in anchors] == [(52416, 4)]
    np.testing.assert_array_equal(N(anchors[0]), np.asarray(
        jrcnn.rpn_level_anchors(jcfg, (832, 1344))[0]))
    rng = np.random.RandomState(10)
    cls = [(np.round(rng.randn(1, 52, 84, 12) * 8) / 4).astype(np.float32)]
    reg = [(rng.randn(1, 52, 84, 48) * 0.2).astype(np.float32)]
    hw = np.asarray([[800.0, 1333.0]], np.float32)
    kw = dict(pre_nms_top_n=6000, post_nms_top_n=300, nms_thr=0.7)
    got = tprop.generate_proposals([T(x) for x in cls], [T(x) for x in reg], anchors, T(hw), **kw)
    ref = jax.jit(lambda c, r: jprop.generate_proposals(
        c, r, [jnp.asarray(N(anchors[0]))], hw, **kw))(cls, reg)
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), rtol=0, atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(N(g), np.asarray(r, np.float32))
    assert int(got[2].sum()) == 300


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def rfcn_variables():
    """The JAX ``PRNGKey(7)`` variables of both R-FCN fixtures (one tree:
    the two shrinks differ in no parameter), jitted, as numpy."""
    jcfg = train_fx.shrink(jax_load_config(os.path.join(REPO, f"configs/{RFCN}.py")))
    tb = train_fx.synthetic_batch(jcfg)
    bundle = jax_build_detector(jcfg)
    return jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb)), tb


def test_detector_reproduces_rfcn_fixture(rfcn_variables):
    """Converted ``PRNGKey(7)`` params reproduce ``detector_rfcn_r50_1x.npz``
    through ``forward_test`` and ``rcnn_postprocess`` (class-agnostic):
    scores, labels and valid at rtol/atol 1e-4, boxes at an absolute 0.05
    px, the Faster fixture's bounds and reason (measured: boxes within
    0.020 px, scores 6.4e-5 of scores near 0.94)."""
    variables, _ = rfcn_variables
    cfg = det_fx.shrink(load_config(RFCN))
    images = np.asarray(det_fx.synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[det_fx.HW[0], det_fx.HW[1], 1.0]], np.float32)
    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    out = model.forward_test(T(images), T(im_info))
    assert out["class_agnostic"] and out["deltas"].shape == (1, 100, 4)
    dets = detector_fns(cfg).postprocess(out, cfg, det_fx.HW, T(im_info))

    ref = np.load(os.path.join(REPO, f"tests/fixtures/detector_{RFCN}.npz"))
    v = N(dets["valid"][0])
    got = {"boxes": N(dets["boxes"][0]) * v[:, None], "scores": N(dets["scores"][0]) * v,
           "labels": N(dets["labels"][0]) * v, "valid": v.astype(np.int32)}
    for k in ("scores", "labels", "valid"):
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k].astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
    assert v.sum() == 20


def test_train_step_reproduces_rfcn_fixture(rfcn_variables):
    """One forward + ``rcnn_loss`` (OHEM: the hardest 16 of 32 sampled rois)
    + backward from the converted variables, the fixture's batch and the JAX
    ``PRNGKey(13)`` draws reproduces ``trainstep_rfcn_r50_1x.npz`` at the
    Faster train fixture's bounds: 2e-5 relative on the losses, 6e-5 on the
    grad norms, the discrete metrics exact (measured on the CPU: losses
    within 1.8e-6, grad norms 1.5e-5 at ``rfcn_offset``, whose gradient
    comes only through the deformable pools' bilinear weights)."""
    variables, tb = rfcn_variables
    cfg = train_fx.shrink(load_config(RFCN))
    model = load_flax_variables(build_detector(cfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    draws = jax_draws(jax.random.PRNGKey(13))
    out = model.forward_train(ttb, draws)
    loss, metrics = detector_fns(cfg).loss(out, ttb, draws, cfg)
    loss.backward()

    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    for mod in ("backbone", "rpn", "conv_new", "rfcn_cls", "rfcn_bbox", "rfcn_offset"):
        got[f"gnorm_{mod}"] = _grad_norm(getattr(model, mod).parameters())
    ref = np.load(os.path.join(REPO, f"tests/fixtures/trainstep_{RFCN}.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0"):
            assert got[k] == r, k
        else:
            rtol = 6e-5 if "norm" in k else 2e-5
            assert abs(got[k] - r) <= rtol * abs(r), (k, got[k], r)


def test_rfcn_defaults_to_the_card():
    """``build_detector`` and ``Trainer`` build R-FCN on the card unless
    asked for the CPU: here, without one, they raise. On the CPU the model
    has the zoo's widths (7 x 7 x 81 = 3969 class maps, 196 box maps, 98
    offset maps, a 512-wide RPN on the 1024-wide C4), its offsets zero
    after the seeded init, stored in the compute dtype at ``train=False``."""
    from mxdetection_tpu_torch.train.trainer import Trainer

    cfg = load_config(RFCN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_detector(cfg, device="cpu", seed=0)
    assert model.rfcn_cls.weight.shape == (3969, 1024, 1, 1)
    assert model.rfcn_bbox.weight.shape == (196, 1024, 1, 1)
    assert model.rfcn_offset.weight.shape == (98, 1024, 1, 1)
    assert float(model.rfcn_offset.weight.abs().max()) == 0.0
    assert model.rpn.rpn_conv.weight.shape == (512, 1024, 3, 3)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
