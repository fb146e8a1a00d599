"""Port parity, training: the Faster R-CNN training step of
``mxdetection_tpu_torch`` against the JAX package on the CPU, in float32.

The ops (box encoding, IoU, matching and sampling, losses, the LR schedule,
the optimizer, the RoIAlign gradient) are held against their JAX functions
on numpy-seeded inputs; the whole step against
``tests/fixtures/trainstep_faster_rcnn_r50_fpn_1x.npz`` (read only) and two
steps of the ``Trainer`` against the JAX ``make_train_step`` on a one-device
mesh. The samplers' random draws cannot be reproduced by torch, so the tests
hand the port the JAX package's own ``jax.random`` draws, made with the same
key splits (``jax_draws``). On the CPU every port function runs its plain
version; the kernels are held against those on the card by ``chip_smoke.py``.
"""

import dataclasses
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.losses import losses as jloss
from mxdetection_tpu.models.registry import build_detector as jax_build_detector
from mxdetection_tpu.ops import boxes as jbox
from mxdetection_tpu.ops import matching as jmatch
from mxdetection_tpu.ops import roi_align as jra
from mxdetection_tpu.ops.pallas.iou import pairwise_iou_pallas
from mxdetection_tpu.ops.pallas.roi_align import multilevel_roi_align_bwd_pallas
from mxdetection_tpu.train.schedule import warmup_multistep as jax_warmup_multistep
from mxdetection_tpu.train.trainer import make_optimizer as jax_make_optimizer

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.losses import losses as tloss
from mxdetection_tpu_torch.models import layers as tlayers
from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_loss
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops import boxes as tbox
from mxdetection_tpu_torch.ops import matching as tmatch
from mxdetection_tpu_torch.ops import roi_align as tra
from mxdetection_tpu_torch.ops.cuda import iou as cuda_iou
from mxdetection_tpu_torch.ops.cuda import roi_align as cuda_roi_align
from mxdetection_tpu_torch.ops.iou import pairwise_iou_batched
from mxdetection_tpu_torch.train.schedule import warmup_multistep
from mxdetection_tpu_torch.train.trainer import Trainer, make_optimizer
from mxdetection_tpu_torch.utils.convert import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_train_fixtures import shrink, synthetic_batch  # noqa: E402

FLAGSHIP = os.path.join(REPO, "configs/faster_rcnn_r50_fpn_1x.py")


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_draws(rng):
    """The port's draw source fed with the JAX package's draws: per image
    the two sub-keys of ``split(rng, B)`` (``sample_rois`` in forward_train)
    or of ``split(fold_in(rng, 1), B)`` (``subsample_labels`` in rcnn_loss)."""
    def draws(name, shape):
        _, b, n = shape
        base = {"sample_rois": rng, "rpn": jax.random.fold_in(rng, 1)}[name]

        def one(key):
            k1, k2 = jax.random.split(key)
            return jnp.stack([jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,))])

        u = jax.vmap(one)(jax.random.split(base, b))  # (B, 2, n)
        return T(u).permute(1, 0, 2).contiguous()
    return draws


def random_boxes(rng, n, size=200.0):
    xy = rng.uniform(-10, size, (n, 2))
    wh = rng.uniform(0, 90, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[::9] = 0.0                      # padding rows
    b[4::13, 2] = b[4::13, 0] - 3.0   # inverted boxes
    return b


# ---------------------------------------------------------------- boxes / IoU


def test_encode_boxes_and_iof_match_jax():
    rng = np.random.RandomState(0)
    rois, gt = random_boxes(rng, 60), random_boxes(rng, 60)
    stds, means = (0.1, 0.1, 0.2, 0.2), (0.0, 0.5, 0.0, -0.5)
    got = N(tbox.encode_boxes(T(rois), T(gt), means=means, stds=stds))
    ref = N(jbox.encode_boxes(rois, gt, means=means, stds=stds))
    assert np.isfinite(got).all()  # the 1e-6 clamps keep degenerate boxes finite
    # log differs by an ulp between the two libraries; the rest is exact
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    a, b = random_boxes(rng, 50), random_boxes(rng, 30)
    np.testing.assert_array_equal(N(tbox.pairwise_iof(T(a), T(b))), N(jbox.pairwise_iof(a, b)))


def test_pairwise_iou_batched_matches_jax_and_pallas():
    """K4's plain path, exactly: against ``boxes.pairwise_iou`` per image and
    the Pallas kernel in interpret mode (the assigner compares IoUs at a
    1e-7 margin and breaks argmax ties by index)."""
    rng = np.random.RandomState(1)
    a = np.stack([random_boxes(rng, 300) for _ in range(2)])
    b = np.stack([random_boxes(rng, 37) for _ in range(2)])
    got = N(pairwise_iou_batched(T(a), T(b)))
    assert got.shape == (2, 300, 37) and got.dtype == np.float32
    for i in range(2):
        np.testing.assert_array_equal(got[i], N(jbox.pairwise_iou(a[i], b[i])))
        np.testing.assert_array_equal(got[i], N(pairwise_iou_pallas(
            jnp.asarray(a[i]), jnp.asarray(b[i]), interpret=True)))
    shared = np.broadcast_to(a[0], a.shape)  # one anchor set for every image
    np.testing.assert_array_equal(N(pairwise_iou_batched(T(a[0]).expand(2, 300, 4), T(b))),
                                  N(pairwise_iou_batched(T(shared), T(b))))
    with pytest.raises(RuntimeError, match="no implementation"):
        pairwise_iou_batched(T(a).to("meta"), T(b).to("meta"))


# ---------------------------------------------------------------- matching


def _assign_inputs(rng):
    anchors = random_boxes(rng, 400)
    gt = np.stack([random_boxes(rng, 6) for _ in range(3)])
    gt[:, 0] = [30.0, 30.0, 90.0, 80.0]
    gt_valid = rng.rand(3, 6) > 0.3
    gt_valid[:, 0] = True
    gt_valid[2] = False                           # an image without gt
    anchors[17] = anchors[18] = [28.0, 29.0, 88.0, 79.0]   # ties for the best gt
    box_valid = rng.rand(3, 400) > 0.1
    return anchors, gt, gt_valid, box_valid


@pytest.mark.parametrize("low_quality", [True, False])
def test_assign_max_iou_matches_jax(low_quality):
    """Labels, matched gt and max IoU exactly equal, with the low-quality
    force (ties included), ``box_valid`` and an image without gt."""
    rng = np.random.RandomState(2)
    anchors, gt, gt_valid, box_valid = _assign_inputs(rng)
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, match_low_quality=low_quality)
    got = tmatch.assign_max_iou(T(anchors).expand(3, 400, 4), T(gt), T(gt_valid),
                                box_valid=T(box_valid), **kw)
    for i in range(3):
        ref = jmatch.assign_max_iou(anchors, gt[i], gt_valid[i], box_valid=box_valid[i], **kw)
        np.testing.assert_array_equal(N(got.labels[i]), N(ref.labels))
        np.testing.assert_array_equal(N(got.matched_gt[i]), N(ref.matched_gt))
        np.testing.assert_array_equal(N(got.max_iou[i]), N(ref.max_iou))
    assert (N(got.labels[2])[box_valid[2]] == 0).all()
    assert (N(got.labels) == -2).sum() == (~box_valid).sum()
    if low_quality:
        assert (N(got.labels[:2]) == 1).any()


def test_subsample_labels_matches_jax():
    rng = np.random.RandomState(3)
    labels = rng.choice([-2, -1, 0, 1], size=(3, 500), p=[0.1, 0.2, 0.55, 0.15]).astype(np.int32)
    labels[2, labels[2] == 1] = 0                 # an image with no positive
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key)
    mask, new = tmatch.subsample_labels(T(labels), 128, 0.5,
                                        tmatch.random_rank(draws, "rpn", 3, 500))
    keys = jax.random.split(jax.random.fold_in(key, 1), 3)
    for i in range(3):
        rmask, rnew = jmatch.subsample_labels(keys[i], labels[i], 128, 0.5)
        np.testing.assert_array_equal(N(mask[i]), N(rmask))
        np.testing.assert_array_equal(N(new[i]), N(rnew))
    assert int(mask[0].sum()) == 128


def test_sample_rois_matches_jax():
    """Rois, labels, matched gt and masks exactly equal on identical inputs
    and draws, with the fg quota binding on one image and the bg band short
    on another (so padding rows appear)."""
    rng = np.random.RandomState(4)
    b, p, g = 3, 200, 5
    gt = np.stack([random_boxes(rng, g) for _ in range(b)])
    gt[:, :2] = [[20.0, 20, 120, 110], [60, 40, 160, 190]]
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, 3:] = False
    gt_labels = rng.randint(1, 81, (b, g)).astype(np.int32)
    props = np.stack([random_boxes(rng, p) for _ in range(b)])
    props[0, :120] = gt[0, 0] + rng.randn(120, 4).astype(np.float32) * 4.0   # many fg
    props[2, 30:] = 0.0                                                       # few rois
    pvalid = np.ones((b, p), bool)
    pvalid[2, 30:] = False
    kw = dict(num_samples=64, pos_fraction=0.25, pos_iou_thr=0.5, neg_iou_thr_hi=0.5,
              neg_iou_thr_lo=0.0)
    key = jax.random.PRNGKey(6)
    got = tmatch.sample_rois(T(props), T(pvalid), T(gt), T(gt_labels), T(gt_valid),
                             tmatch.random_rank(jax_draws(key), "sample_rois", b, g + p), **kw)
    keys = jax.random.split(key, b)
    for i in range(b):
        ref = jmatch.sample_rois(keys[i], props[i], pvalid[i], gt[i], gt_labels[i],
                                 gt_valid[i], **kw)
        for name in ("rois", "labels", "matched_gt", "pos_mask", "valid_mask"):
            np.testing.assert_array_equal(N(getattr(got, name)[i]), N(getattr(ref, name)),
                                          err_msg=f"image {i} {name}")
    assert int(got.pos_mask[0].sum()) == 16 and not bool(got.valid_mask[2].all())


# ---------------------------------------------------------------- losses / schedule / optimizer


@pytest.mark.parametrize("beta", [1.0 / 9.0, 1.0, 0.0])
def test_smooth_l1_and_ce_losses_match_jax(beta):
    rng = np.random.RandomState(7)
    pred, tgt = rng.randn(64, 4).astype(np.float32), rng.randn(64, 4).astype(np.float32)
    np.testing.assert_allclose(N(tloss.smooth_l1_loss(T(pred), T(tgt), beta)),
                               N(jloss.smooth_l1_loss(pred, tgt, beta)), rtol=1e-6, atol=1e-7)
    logits = (rng.randn(40, 9) * 3).astype(np.float32)
    labels = rng.randint(-1, 9, 40)
    valid = labels >= 0
    np.testing.assert_allclose(float(tloss.softmax_ce_loss(T(logits), T(labels), T(valid))),
                               float(jloss.softmax_ce_loss(logits, labels, valid)), rtol=1e-6)


def test_warmup_multistep_matches_jax():
    kw = dict(warmup_steps=500, warmup_ratio=1.0 / 3.0, decay_steps=(800, 1100),
              decay_factor=0.1)
    got, ref = warmup_multistep(0.02, **kw), jax_warmup_multistep(0.02, **kw)
    for step in (0, 1, 7, 250, 499, 500, 501, 799, 800, 1099, 1100, 5000):
        assert np.float32(got(step)) == np.float32(ref(step)), step


def test_make_optimizer_matches_optax():
    """Five steps of the port's optimizer against the JAX package's optax
    chain on a small parameter tree, with the clip active, the schedule in
    warm-up and one parameter without gradient (a frozen stage, still
    decayed): parameters agree to f32 rounding."""
    cfg = load_config(FLAGSHIP, {"train.optim.warmup_steps": 10, "train.optim.grad_clip": 3.0})
    jtx, _ = jax_make_optimizer(jax_load_config(FLAGSHIP, {"train.optim.warmup_steps": 10,
                                                           "train.optim.grad_clip": 3.0}), 100)
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32),
              "frozen": rng.randn(4).astype(np.float32)}
    names = sorted(params)
    tparams = [T(params[k]) for k in names]
    opt, _ = make_optimizer(cfg, tparams, 100)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = jtx.init(jparams)
    for _ in range(5):
        grads = {k: (rng.randn(*params[k].shape) * 4).astype(np.float32) for k in names}
        grads["frozen"] = np.zeros(4, np.float32)
        norm = opt.step([None if k == "frozen" else T(grads[k]) for k in names])
        assert abs(float(norm) - float(optax.global_norm(grads))) <= 1e-6 * float(norm)
        assert float(norm) > 3.0  # the clip is active
        updates, state = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, state,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
    for k, p in zip(names, tparams):
        np.testing.assert_allclose(N(p), N(jparams[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(N(tparams[names.index("frozen")]), params["frozen"])


# ---------------------------------------------------------------- RoIAlign gradient (K3's twin)


def _roi_grad_port(feats, rois, strides, g, valid):
    ft = [T(f).requires_grad_() for f in feats]
    out = tra.multilevel_roi_align(ft, T(rois), strides, roi_valid=T(valid))
    out.backward(T(g))
    return [N(f.grad) for f in ft]


def test_roi_align_grad_matches_jax_vjp():
    """Autograd of the port's RoIAlign (K3's plain twin) against ``jax.vjp``
    of the JAX reference: every level, rois overhanging the edges, invalid
    rois contributing nothing. f32 sums in another order: atol 1e-5."""
    rng = np.random.RandomState(9)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(2, 64 >> i, 48 >> i, 16).astype(np.float32) for i in range(4)]
    side = np.exp(rng.uniform(2.0, 5.3, (2, 40)))
    cx, cy = rng.uniform(-20, 212, (2, 40)), rng.uniform(-20, 276, (2, 40))
    rois = np.stack([cx - side / 2, cy - side / 3, cx + side / 2, cy + side / 3], -1)
    rois = rois.astype(np.float32)
    valid = rng.rand(2, 40) > 0.2
    g = rng.randn(2, 40, 7, 7, 16).astype(np.float32)
    got = _roi_grad_port(feats, rois, strides, g, valid)

    def fwd(fs, r, v):
        return jra.multilevel_roi_align(fs, r, strides, roi_valid=v)

    for i in range(2):
        _, vjp = jax.vjp(lambda fs: fwd(fs, rois[i], valid[i]), [f[i] for f in feats])
        ref = vjp(g[i])[0]
        for lv in range(4):
            np.testing.assert_allclose(got[lv][i], N(ref[lv]), rtol=0, atol=1e-5,
                                       err_msg=f"image {i} level {lv}")
    assert any(np.abs(x).max() > 0 for x in got)


def test_roi_align_grad_matches_pallas_bwd_interpret():
    """Against the Pallas backward (K3) in interpret mode, C = 128, rois
    under the kernel's 24:1 aspect limit (the CUDA kernel has none)."""
    rng = np.random.RandomState(10)
    shapes, strides = [(32, 32), (16, 16)], (8, 16)
    feats = [rng.randn(1, h, w, 128).astype(np.float32) for h, w in shapes]
    rois = np.asarray([[[8.0, 8, 80, 70], [20, 30, 230, 210], [4.0, 4, 30, 30]]], np.float32)
    valid = np.asarray([[True, True, False]])
    g = rng.randn(1, 3, 7, 7, 128).astype(np.float32)
    got = _roi_grad_port(feats, rois, strides, g, valid)
    ref = multilevel_roi_align_bwd_pallas(shapes, jnp.asarray(g[0]), jnp.asarray(rois[0]),
                                          strides, roi_valid=jnp.asarray(valid[0]),
                                          interpret=True)
    for lv in range(2):
        # the kernel contracts separable weight matrices: another association
        np.testing.assert_allclose(got[lv][0], N(ref[lv]), rtol=1e-5, atol=1e-5)


def _bwd_call(**over):
    kw = dict(grad_out=torch.zeros(2, 5, 7, 7, 8), feature_shapes=[(16, 12), (8, 6)],
              rois=torch.zeros(2, 5, 4), strides=(4, 8),
              levels=torch.zeros(2, 5, dtype=torch.int32))
    kw.update(over)
    return lambda: cuda_roi_align.roi_align_bwd_cuda(**kw)


TRAIN_WRAPPER_CASES = {
    "bwd_rank": (ValueError, "P, P, C", _bwd_call(grad_out=torch.zeros(2, 5, 7, 8))),
    "bwd_dtype": (TypeError, "dtypes", _bwd_call(grad_out=torch.zeros(2, 5, 7, 7, 8,
                                                                      dtype=torch.float16))),
    "bwd_strides": (ValueError, "stride", _bwd_call(strides=(4,))),
    "bwd_levels_shape": (ValueError, "levels", _bwd_call(levels=torch.zeros(2, 4))),
    "bwd_cpu": (ValueError, "CUDA", _bwd_call()),
    "convert_dtype": (ValueError, "f32", lambda: cuda_roi_align.f32_to_bf16_cuda(
        torch.zeros(4, dtype=torch.float16))),
    "convert_cpu": (ValueError, "CUDA", lambda: cuda_roi_align.f32_to_bf16_cuda(torch.zeros(4))),
    "iou_shape": (ValueError, "boxes1", lambda: cuda_iou.pairwise_iou_cuda(
        torch.zeros(2, 5, 4), torch.zeros(3, 5, 4))),
    "iou_dtype": (TypeError, "f32", lambda: cuda_iou.pairwise_iou_cuda(
        torch.zeros(2, 5, 4, dtype=torch.float64), torch.zeros(2, 5, 4))),
    "iou_wide": (ValueError, "G=", lambda: cuda_iou.pairwise_iou_cuda(
        torch.zeros(1, 5, 4), torch.zeros(1, 4096, 4))),
    "iou_cpu": (ValueError, "CUDA", lambda: cuda_iou.pairwise_iou_cuda(
        torch.zeros(2, 5, 4), torch.zeros(2, 5, 4))),
}


@pytest.mark.parametrize("case", sorted(TRAIN_WRAPPER_CASES))
def test_training_cuda_wrappers_validate_before_launch(case, monkeypatch):
    """K3, K3b and K4's wrappers refuse what their kernels do not take, and
    any tensor not on a CUDA device, before building or launching anything."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cuda_roi_align, "load_library", no_build)
    monkeypatch.setattr(cuda_iou, "load_library", no_build)
    exc, match, call = TRAIN_WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        call()


# ---------------------------------------------------------------- network pieces


def test_frozen_bn_keeps_the_input_dtype():
    m = tlayers.FrozenBatchNorm(6)
    x = torch.randn(2, 6, 3, 4, dtype=torch.bfloat16)
    assert m(x).dtype == torch.bfloat16 and m.gamma.dtype == torch.float32
    conv = tlayers.conv(6, 4, 3, use_bias=True)
    assert conv(x).dtype == torch.bfloat16 and conv.weight.dtype == torch.float32


def test_frozen_stages_detach_where_jax_stops_gradients():
    cfg = load_config(FLAGSHIP, {"backbone.dtype": "float32"})
    model = build_detector(cfg, device="cpu", seed=0, train=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    c2, c3, _, _ = model.backbone(torch.randn(1, 64, 64, 3))
    assert not c2.requires_grad and c3.requires_grad
    c3.float().sum().backward()
    bb = model.backbone
    assert bb.stem_conv.weight.grad is None
    assert all(p.grad is None for p in bb.layer1_block2.parameters())
    assert bb.layer2_block0.conv1.weight.grad.abs().sum() > 0


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def flagship():
    """The shrunk flagship in both packages and the JAX ``PRNGKey(7)``
    params of the train-step fixture, as numpy."""
    jcfg = shrink(jax_load_config(FLAGSHIP))
    bundle = jax_build_detector(jcfg)
    tb = synthetic_batch(jcfg)
    variables = jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb))
    return jcfg, shrink(load_config(FLAGSHIP)), bundle, tb, variables


def _grad_norm(params):
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in params
                                if p.grad is not None)))


def test_train_step_reproduces_jax_fixture(flagship):
    """From converted ``PRNGKey(7)`` params, ``test_train_fixtures``'s batch
    and the JAX ``PRNGKey(13)`` draws, one forward + backward reproduces
    ``trainstep_faster_rcnn_r50_fpn_1x.npz``.

    Measured gaps on the CPU: the loss terms within 7.1e-6 relative, the
    global grad norm 8.7e-7, the per-module grad norms 2.7e-5 (FPN) and
    2.2e-5 (backbone). The random-weight net carries losses of ~150 and grad
    norms of ~7e3, so f32 convolutions summed in another order than XLA's
    move the last digits; the bounds are about twice the gaps: 2e-5 on the
    losses, 6e-5 on the grad norms. The sampled rois, the number of
    positives and the accuracy are discrete and must be exact: one roi
    picked differently moves the loss by far more than the bound.
    """
    _, tcfg, _, tb, variables = flagship
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    draws = jax_draws(jax.random.PRNGKey(13))
    loss, metrics = rcnn_loss(model.forward_train(ttb, draws), ttb, draws, tcfg)
    loss.backward()

    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    for mod in ("backbone", "fpn", "rpn", "bbox_head0"):
        got[f"gnorm_{mod}"] = _grad_norm(getattr(model, mod).parameters())
    ref = np.load(os.path.join(REPO, "tests/fixtures/trainstep_faster_rcnn_r50_fpn_1x.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0"):
            assert got[k] == r, k
        else:
            rtol = 6e-5 if "norm" in k else 2e-5
            assert abs(got[k] - r) <= rtol * abs(r), (k, got[k], r)


def test_trainer_two_steps_match_jax_train_step(flagship):
    """Two ``Trainer.run_step``s (transform, forward, loss, backward,
    update) against the JAX ``make_train_step`` on a one-device mesh, with
    the JAX draws of each step (``fold_in(PRNGKey(seed), step)``).

    Measured gaps on the CPU: step 1's loss within 2.8e-6 relative and its
    grad norm 5.8e-6; after step 2 the parameter global norm within 3.9e-8
    and the loss 1.2e-4. The random-weight net amplifies: step 1's update is
    the clipped gradient (norm 8.4e4 cut to 35), whose direction differs by
    ~6e-6 between the packages; against a loss gradient of norm ~8e4 that
    moves step 2's loss of 782 by ~0.1. Bounds are about 2.5 times the
    gaps: 3e-4 on the loss, 1e-7 on the parameter norm. The discrete
    metrics must be exact at both steps.
    """
    from mxdetection_tpu.parallel import make_mesh
    from mxdetection_tpu.train import Trainer as JaxTrainer

    jcfg, tcfg, bundle, tb, variables = flagship
    rng = np.random.RandomState(11)
    batch = {"raw": rng.randint(0, 256, (2, 240, 300, 3)).astype(np.uint8),
             "hw": np.asarray([[240.0, 300.0], [200.0, 280.0]], np.float32),
             "flip": np.asarray([False, True]), "gt_boxes": np.asarray(tb["gt_boxes"]),
             "gt_labels": np.asarray(tb["gt_labels"]), "gt_valid": np.asarray(tb["gt_valid"])}
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, bundle.apply_train, variables, bundle.loss_fn, mesh,
                    steps_per_epoch=100)
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    tt = Trainer(tcfg, model, steps_per_epoch=100, device="cpu")
    for step in range(2):
        ref = jt.run_step(batch)
        got = tt.run_step(batch, draws=jax_draws(
            jax.random.fold_in(jax.random.PRNGKey(tcfg.train.seed), step)))
        for k in ("num_pos_rois", "rcnn_acc0"):
            assert float(got[k]) == float(ref[k]), (step, k)
    assert abs(float(got["loss"]) - float(ref["loss"])) <= 3e-4 * abs(float(ref["loss"]))
    jnorm = float(optax.global_norm(jt.state.params))
    tnorm = float(torch.sqrt(sum((p.double() ** 2).sum() for p in model.parameters())))
    assert abs(tnorm - jnorm) <= 1e-7 * jnorm, (tnorm, jnorm)
    assert tt.optimizer.count == 2


# ---------------------------------------------------------------- repairs


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs/*.py"))))
def test_zoo_configs_equal_the_jax_configs(path):
    """The port's own zoo gives, field for field, what the JAX package's
    ``load_config`` of the same file gives, by path and by name."""
    ref = dataclasses.asdict(jax_load_config(path))
    assert dataclasses.asdict(load_config(path)) == ref
    assert dataclasses.asdict(load_config(os.path.basename(path)[:-3])) == ref


def test_entry_points_default_to_the_card():
    """``build_detector`` and ``Trainer`` run on the card unless asked for
    the CPU: here, without one, they raise instead of falling back."""
    assert not torch.cuda.is_available()
    cfg = load_config(FLAGSHIP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_detector(cfg.override(**{"backbone.dtype": "float32"}), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, model)
