"""Port parity, the Cascade R-CNN R101-DCN training step: the deformable
conv's backward (``ops/dcn.py::deform_conv2d_backward``, the registered
backward of ``mxdet::deform_conv2d``) and the cascade's
training path of ``mxdetection_tpu_torch`` against the JAX package on the
CPU, in float32, from numpy-seeded inputs.

On the CPU the backward runs its plain versions (``deform_wgrad_doffsets``,
built on ``deform_patches_doffsets`` and the dW product, and
``deform_col2im``, beside dpatch = g W^T); the CUDA kernels (K6/K6b, the
fused weight gradient, and K7/K7b, ``csrc/deform_conv_bwd.cu``) cannot run
here and are held against those plain versions on the card by
``chip_smoke.py``. Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The samplers'
random draws are the JAX package's (``jax_draws``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.models.detectors.rcnn import relabel_rois as jax_relabel_rois
from mxdetection_tpu.models.registry import build_detector as jax_build_detector
from mxdetection_tpu.ops import dcn as jdcn
from mxdetection_tpu.ops.pallas.dcn import (deform_conv2d_bwd_pallas_batched,
                                            deform_conv2d_s2_bwd_pallas_batched)

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_loss, relabel_rois
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops import dcn as tdcn
from mxdetection_tpu_torch.ops.cuda import deform_conv as cuda_dcn
from mxdetection_tpu_torch.utils.convert import load_flax_variables

from test_torch_port_dcn import CASCADE, CASCADE_OFFSET_NOISE, dcn_inputs, noisy_offsets
from test_torch_port_train import (  # noqa: F401  (fixtures)
    N, T, _grad_norm, default_torch_threads, jax_draws, one_torch_thread, random_boxes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_train_fixtures import shrink, synthetic_batch  # noqa: E402

MODULES = ("backbone", "fpn", "rpn", "bbox_head0", "bbox_head1", "bbox_head2")


def port_grads(x, off, wt, g, **kw):
    """(dx, doffsets, dW) of ``deform_conv2d_batched`` (the Function) as numpy."""
    leaves = [T(a).requires_grad_() for a in (x, off, wt)]
    tdcn.deform_conv2d_batched(*leaves, **kw).backward(T(g))
    return [N(a.grad) for a in leaves]


def assert_grads_close(got, ref, rtol):
    """Each gradient within ``rtol`` of its largest entry."""
    for gg, rr, name in zip(got, ref, ("dx", "doffsets", "dweight")):
        rr = np.asarray(rr)
        scale = np.abs(rr).max()
        assert scale > 0, name
        np.testing.assert_allclose(gg, rr, rtol=0, atol=rtol * scale, err_msg=name)


def upstream(rng, x, wt, stride):
    b, h, w = x.shape[:3]
    return rng.randn(b, -(-h // stride), -(-w // stride), wt.shape[3]).astype(np.float32)


# ---------------------------------------------------------------- the plain backward


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_deform_conv_backward_matches_jax_grad(stride, dilation):
    """dx, doffsets and dW of the Function against ``jax.grad`` of the JAX
    gather (``mxdetection_tpu/ops/dcn.py::deform_conv2d``), within 1e-5 of
    the largest gradient: the same f32 formulas, summed in another order.
    Offsets of std 2 cells put samples beyond +-3 and outside the map."""
    rng = np.random.RandomState(60 + stride + 2 * dilation)
    x, off, wt = dcn_inputs(rng, 2, 11, 13, 8, 12, stride)
    g = upstream(rng, x, wt, stride)

    def loss(x, off, w):
        out = jax.vmap(lambda xi, oi: jdcn.deform_conv2d(xi, oi, w, stride=stride,
                                                          dilation=dilation))(x, off)
        return jnp.sum(out * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(x, off, wt)
    assert_grads_close(port_grads(x, off, wt, g, stride=stride, dilation=dilation), ref, 1e-5)


@pytest.mark.parametrize("stride,radius", [(1, None), (2, None), (1, 3), (2, 3)])
def test_deform_conv_function_matches_autograd_of_plain(stride, radius):
    """The Function's backward (dpatch = g W^T, ``deform_wgrad_doffsets``
    and ``deform_col2im``) against torch autograd of the plain forward
    ``deform_conv2d``, within 1e-5 of the largest gradient; with
    ``radius=3`` the clip's gradient zeroes the offsets beyond +-3."""
    rng = np.random.RandomState(70 + stride)
    x, off, wt = dcn_inputs(rng, 2, 9, 12, 16, 8, stride)
    g = upstream(rng, x, wt, stride)
    leaves = [T(a).requires_grad_() for a in (x, off, wt)]
    tdcn.deform_conv2d(*leaves, stride=stride, radius=radius).backward(T(g))
    got = port_grads(x, off, wt, g, stride=stride, radius=radius)
    assert_grads_close(got, [N(a.grad) for a in leaves], 1e-5)
    if radius is not None:
        assert (got[1][np.abs(off) > radius] == 0).all() and (np.abs(off) > radius).any()


def pallas_case(rng, stride):
    """``tests/test_pallas_dcn_bwd.py``'s case at 12x10x128: offsets
    uniform in +-4 cells, some beyond the clamp."""
    h, w = 12, 10
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.randn(1, h, w, 128).astype(np.float32)
    off = ((rng.rand(1, ho, wo, 18) - 0.5) * 8).astype(np.float32)
    wt = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    g = rng.randn(1, ho, wo, 128).astype(np.float32)
    return x, off, wt, g


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_backward_radius_matches_pallas_interpret(stride):
    """``radius=3`` against the Pallas backward (K6 + K7 at stride 1, K6b +
    K7b at stride 2, with their XLA products) in interpret mode, with
    ``tests/test_pallas_dcn_bwd.py``'s tolerance, 2e-3: the Pallas kernels
    sum the bilinear terms per integer displacement, so they differ from the
    gather by rounding."""
    x, off, wt, g = pallas_case(np.random.RandomState(80 + stride), stride)
    fn = deform_conv2d_bwd_pallas_batched if stride == 1 else deform_conv2d_s2_bwd_pallas_batched
    ref = fn(*(jnp.asarray(a) for a in (x, off, wt, g)), radius=3, interpret=True)
    got = port_grads(x, off, wt, g, stride=stride, radius=3)
    for gg, rr, name in zip(got, ref, ("dx", "doffsets", "dweight")):
        np.testing.assert_allclose(gg, np.asarray(rr), rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
def test_zero_offsets_backward_gives_conv2d_grads(stride):
    """At zero offsets (the DCN init) dx and dW are the plain conv's, an
    external golden: autograd of ``F.conv2d``, within 1e-5 of the largest
    gradient. The offset gradient there is one-sided, v(y0+1) - v(y0)."""
    rng = np.random.RandomState(90 + stride)
    x, off, wt = dcn_inputs(rng, 2, 10, 9, 8, 16, stride)
    off[:] = 0.0
    g = upstream(rng, x, wt, stride)
    dx, doff, dw = port_grads(x, off, wt, g, stride=stride)
    xt, wc = T(x).permute(0, 3, 1, 2).requires_grad_(), T(wt).permute(3, 2, 0, 1).requires_grad_()
    F.conv2d(xt, wc, stride=stride, padding=1).permute(0, 2, 3, 1).backward(T(g))
    assert_grads_close([dx, dw], [N(xt.grad.permute(0, 2, 3, 1)), N(wc.grad.permute(2, 3, 1, 0))],
                       1e-5)
    # doy at tap (0, 0) of an interior pixel: sum_c dpatch * (x[i, j-1] - x[i-1, j-1])
    dpatch = (g[0, 3, 4] @ wt.reshape(9, 8, 16).transpose(0, 2, 1)).reshape(9, 8)
    i, j = 3 * stride - 1, 4 * stride - 1
    assert abs(doff[0, 3, 4, 0] - dpatch[0] @ (x[0, i + 1, j] - x[0, i, j])) < 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_patches_doffsets_and_col2im_plain_versions(stride):
    """K6's plain version rebuilds the forward's rounded patch rows exactly
    and its doffsets are the gradient of <dpatch, patches> in the offsets;
    K7's is the vector-Jacobian product of the sampling in x (torch
    autograd of ``deform_sample_patches``), within 1e-5 of the largest."""
    rng = np.random.RandomState(100 + stride)
    x, off, _ = dcn_inputs(rng, 2, 9, 11, 8, 8, stride)
    dp = rng.randn(*off.shape[:3], 9 * 8).astype(np.float32)
    patches, doff = tdcn.deform_patches_doffsets(T(x), T(off), T(dp), stride=stride)
    xt, ot = T(x).requires_grad_(), T(off).requires_grad_()
    ref = tdcn.deform_sample_patches(xt, ot, stride=stride)
    torch.testing.assert_close(patches, ref.detach(), rtol=0, atol=0)
    ref.backward(T(dp))
    dx = tdcn.deform_col2im(T(dp), T(off), x.shape, stride=stride)
    assert_grads_close([N(dx), N(doff)], [N(xt.grad), N(ot.grad)], 1e-5)


def _bwd_call(what, **over):
    """A call of K6's wrapper (``deform_wgrad_doffsets_cuda``; the cases
    named ``patches_*`` hold the checks the unfused patches wrapper made) or
    of K7's, on CPU tensors that pass every check but ``over``'s."""
    kw = dict(x=torch.zeros(1, 6, 8, 64), offsets=torch.zeros(1, 6, 8, 18),
              dpatch=torch.zeros(1, 6, 8, 576), g=torch.zeros(48, 128), stride=1)
    kw.update(over)
    if what == "patches":
        return lambda: cuda_dcn.deform_wgrad_doffsets_cuda(**kw)
    return lambda: cuda_dcn.deform_col2im_cuda(kw["dpatch"], kw["offsets"], kw["x"].shape,
                                               stride=kw["stride"])


def _bf16(**kw):
    return {k: v.bfloat16() for k, v in kw.items()}


BWD_WRAPPER_CASES = {
    "patches_dtype": (TypeError, "dtype", _bwd_call("patches", x=torch.zeros(
        1, 6, 8, 64, dtype=torch.float16))),
    "patches_mixed": (TypeError, "dtype", _bwd_call("patches", dpatch=torch.zeros(
        1, 6, 8, 576, dtype=torch.bfloat16))),
    "patches_offsets_dtype": (TypeError, "offsets", _bwd_call("patches", offsets=torch.zeros(
        1, 6, 8, 18, dtype=torch.float64))),
    "patches_offsets_shape": (ValueError, "offsets", _bwd_call("patches", stride=2)),
    "patches_dpatch_shape": (ValueError, "dpatch", _bwd_call("patches", dpatch=torch.zeros(
        1, 6, 8, 512))),
    "patches_channels": (ValueError, "C=6", _bwd_call("patches", x=torch.zeros(1, 6, 8, 6),
                                                      dpatch=torch.zeros(1, 6, 8, 54))),
    "patches_layout": (ValueError, "contiguous", _bwd_call(
        "patches", x=torch.zeros(1, 8, 6, 64).transpose(1, 2))),
    "patches_cpu": (ValueError, "CUDA", _bwd_call("patches")),
    "wgrad_channels": (ValueError, "C=32 must be a multiple of 64", _bwd_call(
        "patches", x=torch.zeros(1, 6, 8, 32), dpatch=torch.zeros(1, 6, 8, 288))),
    "wgrad_g_dtype": (TypeError, "g torch.bfloat16", _bwd_call(
        "patches", g=torch.zeros(48, 128, dtype=torch.bfloat16))),
    "wgrad_g_shape": (ValueError, r"g \(47, 128\)", _bwd_call("patches", g=torch.zeros(47, 128))),
    "wgrad_g_layout": (ValueError, "g must be contiguous", _bwd_call(
        "patches", g=torch.zeros(128, 48).t())),
    "wgrad_cout_f32": (ValueError, "Cout=96", _bwd_call("patches", g=torch.zeros(48, 96))),
    "wgrad_cout_bf16": (ValueError, "Cout=192", _bwd_call("patches", **_bf16(
        x=torch.zeros(1, 6, 8, 64), dpatch=torch.zeros(1, 6, 8, 576), g=torch.zeros(48, 192)))),
    "col2im_stride": (ValueError, "stride 3", _bwd_call("col2im", stride=3)),
    "col2im_dpatch_dtype": (TypeError, "dpatch", _bwd_call("col2im", dpatch=torch.zeros(
        1, 6, 8, 576, dtype=torch.int32))),
    "col2im_layout": (ValueError, "contiguous", _bwd_call(
        "col2im", dpatch=torch.zeros(1, 6, 576, 8).transpose(2, 3))),
    "col2im_cpu": (ValueError, "CUDA", _bwd_call("col2im")),
}


@pytest.mark.parametrize("case", sorted(BWD_WRAPPER_CASES))
def test_deform_conv_bwd_cuda_wrappers_validate_before_launch(case, monkeypatch):
    """K6's (the fused weight gradient's) and K7's wrappers refuse what
    their kernels do not take, and any tensor not on a CUDA device, before
    building or launching anything."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cuda_dcn, "load_library", no_build)
    exc, match, call = BWD_WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        call()


# ---------------------------------------------------------------- relabel_rois


def test_relabel_rois_matches_jax():
    """Labels, matched gt and positives exactly equal to the JAX function
    per image: invalid gt at IoU -1, argmax ties to the first gt, invalid
    rois -1, an image without valid gt all background."""
    rng = np.random.RandomState(110)
    b, r, g = 3, 300, 6
    gt = np.stack([random_boxes(rng, g) for _ in range(b)])
    gt[:, 0] = [30.0, 30.0, 90.0, 80.0]
    gt[:, 3] = gt[:, 0]                                   # a duplicate: argmax ties
    gt_valid = rng.rand(b, g) > 0.3
    gt_valid[:2, [0, 3]] = True
    gt_valid[2] = False
    gt_labels1 = rng.randint(1, 81, (b, g)).astype(np.int32) * gt_valid
    rois = np.stack([random_boxes(rng, r) for _ in range(b)])
    rois[:, :40] = gt[:, :1] + rng.randn(b, 40, 4).astype(np.float32) * 5.0
    roi_valid = rng.rand(b, r) > 0.1
    got = relabel_rois(T(rois), T(roi_valid), T(gt), T(gt_labels1), T(gt_valid), 0.6)
    for i in range(b):
        ref = jax_relabel_rois(rois[i], roi_valid[i], gt[i], gt_labels1[i], gt_valid[i], 0.6)
        for name, gg, rr in zip(("labels", "matched", "pos"), got, ref):
            np.testing.assert_array_equal(N(gg[i]), N(rr), err_msg=f"image {i} {name}")
    assert int(got[2][:2].sum()) > 10 and not bool(got[2][2].any())


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def cascade_train():
    """The shrunk cascade of the train-step fixture in both packages (R50,
    DCN in stage 4 only, 256x320, f32), its batch and the JAX
    ``PRNGKey(7)`` params, as numpy."""
    jcfg = shrink(jax_load_config(os.path.join(REPO, f"configs/{CASCADE}.py")))
    bundle = jax_build_detector(jcfg)
    tb = synthetic_batch(jcfg)
    variables = jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return jcfg, shrink(load_config(CASCADE)), tb, variables


def port_step(tcfg, variables, tb, rng):
    """One forward + backward of the port from converted params -> (the
    model, its loss, metrics and per-module grad norms as floats)."""
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    draws = jax_draws(rng)
    loss, metrics = rcnn_loss(model.forward_train(ttb, draws), ttb, draws, tcfg)
    loss.backward()
    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    got.update({f"gnorm_{m}": _grad_norm(getattr(model, m).parameters()) for m in MODULES})
    return model, got


def test_cascade_train_step_reproduces_jax_fixture(cascade_train):
    """From converted ``PRNGKey(7)`` params, ``test_train_fixtures``'s batch
    and the JAX ``PRNGKey(13)`` draws, one forward + backward reproduces
    ``trainstep_cascade_rcnn_r101_dcn_1x.npz``. Its loss, 188.594, is
    10.487 (RPN) + 1 * 138.359 + 0.5 * 36.056 + 0.25 * 86.881: the stage
    weights (1, 0.5, 0.25); the unweighted sum is 271.78.

    Measured gaps on the CPU: the loss 2.3e-6 relative, the stage losses up
    to 6.9e-5 (``loss_rcnn_cls1``: stages 1 and 2 see rois decoded from the
    previous stage's deltas, so a last-digit change of the deltas moves
    their RoIAlign samples), the grad norms up to 6.9e-5 (backbone). Bounds
    are about twice that: 1.5e-4 on both. The number of positives and the
    accuracies are discrete and must be exact. The fixture's offset convs
    are zero, so its DCN samples on the grid, where the offset gradient is
    one-sided; the live test below adds noise.
    """
    _, tcfg, tb, variables = cascade_train
    model, got = port_step(tcfg, variables, tb, jax.random.PRNGKey(13))
    ref = np.load(os.path.join(REPO, f"tests/fixtures/trainstep_{CASCADE}.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0", "metric_rcnn_acc1",
                 "metric_rcnn_acc2"):
            assert got[k] == r, k
        else:
            assert abs(got[k] - r) <= 1.5e-4 * abs(r), (k, got[k], r)
    weights = tcfg.cascade.stage_loss_weights
    total = got["metric_loss_rpn_cls"] + got["metric_loss_rpn_reg"] + sum(
        w * (got[f"metric_loss_rcnn_cls{i}"] + got[f"metric_loss_rcnn_reg{i}"])
        for i, w in enumerate(weights))
    assert weights == (1.0, 0.5, 0.25) and abs(got["loss"] - total) <= 1e-6 * total
    dcn = model.backbone.layer4_block0.conv2
    assert dcn.offset_conv.weight.grad.abs().max() > 0 and dcn.weight.grad.abs().max() > 0


def test_cascade_train_converts_heads_and_offset_convs(cascade_train):
    """``load_flax_variables`` carries the three cascade heads and every
    offset conv into a train-mode model, as f32 master weights."""
    _, tcfg, _, variables = cascade_train
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for i in range(3):
        ref = variables["params"][f"bbox_head{i}"]["bbox_pred"]["kernel"]
        np.testing.assert_array_equal(N(model.bbox_head(i).bbox_pred.weight), ref.T)
    backbone = variables["params"]["backbone"]
    names = [n for n in backbone if "offset_conv" in backbone[n].get("conv2", {})]
    assert len(names) == 3  # the shrunk config's stage 4
    for n in names:
        ref = backbone[n]["conv2"]["offset_conv"]
        conv = getattr(model.backbone, n).conv2.offset_conv
        np.testing.assert_array_equal(N(conv.weight), ref["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(N(conv.bias), ref["bias"])


# Stage thresholds low enough, and stage-0/1 deltas small enough, that the
# refined rois of stages 1 and 2 keep some positives (the fixture's
# loss_rcnn_reg1 and reg2 are 0: its random heads move every roi away).
LIVE_IOU_THRS = (0.5, 0.4, 0.3)
LIVE_DELTA_SCALE = 0.01


def live_steps(cascade_train, **over):
    """``value_and_grad`` of the JAX train step, run live, and the port's
    step, from ``cascade_train``'s params with a noisy offset conv in the
    first stage-4 DCN, ``cascade.stage_iou_thrs`` lowered, the regression
    outputs of heads 0 and 1 scaled, and the config overrides ``over`` on
    both sides -> (the JAX metrics and grad norms, the noisy offset conv's
    JAX gradient, the port's model, its metrics and grad norms)."""
    jcfg, tcfg, tb, variables = cascade_train
    over = {"cascade.stage_iou_thrs": LIVE_IOU_THRS, **over}
    jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    variables = jax.tree_util.tree_map(np.copy, variables)
    noisy_offsets(variables["params"]["backbone"]["layer4_block0"], 56, CASCADE_OFFSET_NOISE)
    for head in ("bbox_head0", "bbox_head1"):
        for leaf in ("kernel", "bias"):
            variables["params"][head]["bbox_pred"][leaf] *= LIVE_DELTA_SCALE
    bundle = jax_build_detector(jcfg)
    rng = jax.random.PRNGKey(13)

    def loss_fn(params):
        outputs, _ = bundle.apply_train(
            {"params": params, "batch_stats": variables.get("batch_stats", {})}, tb, rng)
        return bundle.loss_fn(outputs, tb, rng, jcfg)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    ref = {"loss": float(loss), **{f"metric_{k}": float(v) for k, v in metrics.items()}}
    ref.update({f"gnorm_{m}": float(optax.global_norm(grads[m])) for m in MODULES})
    ref_off = np.asarray(grads["backbone"]["layer4_block0"]["conv2"]["offset_conv"]["kernel"])
    model, got = port_step(tcfg, variables, tb, rng)
    return ref, ref_off, model, got


def assert_live_steps_close(ref, ref_off, model, got):
    """``live_steps``' two steps within the bounds of the live test below."""
    for k, r in ref.items():
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0", "metric_rcnn_acc1",
                 "metric_rcnn_acc2"):
            assert got[k] == r, k
        else:
            assert abs(got[k] - r) <= (1.2e-3 if "gnorm" in k else 6e-5) * abs(r), (k, got[k], r)
    assert ref["metric_loss_rcnn_reg1"] > 0 and ref["metric_loss_rcnn_reg2"] > 0
    got_off = N(model.backbone.layer4_block0.conv2.offset_conv.weight.grad.permute(2, 3, 1, 0))
    np.testing.assert_allclose(got_off, ref_off, rtol=0, atol=4e-3 * np.abs(ref_off).max())


def test_cascade_train_step_matches_live_jax(cascade_train, default_torch_threads):
    """``value_and_grad`` of the JAX train step, run live, with a noisy
    offset conv in the first stage-4 DCN (offsets of std 4.5 cells, many
    corners off the map), ``cascade.stage_iou_thrs`` lowered and the
    regression outputs of heads 0 and 1 scaled by 0.01, so stages 1 and 2
    have positives (2 and 1 per image).

    Measured gaps on the CPU: losses within 2.7e-5 relative, per-module grad
    norms 5.7e-4 (backbone), the noisy offset conv's gradient 1.7e-3 of its
    largest entry. A 1e-6 relative change of the input moves JAX's own
    backbone grad norm by 3.7e-4 and that gradient by 3.9e-3, so these are
    the conditioning of a random-weight net with noisy offsets, not the
    port. Bounds: 6e-5 on the losses, 1.2e-3 on the grad norms, 4e-3 on the
    offset conv's gradient; discrete metrics exact."""
    assert_live_steps_close(*live_steps(cascade_train))


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """``csrc/deform_common.cuh`` is included, not compiled on its own, so
    the build's source hash must cover it: an edit to a header rebuilds."""
    from mxdetection_tpu_torch.ops.cuda import build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build.library_path()
    header.write_text("// two\n")
    assert build.library_path() != before
    assert os.path.exists(os.path.join(build.PKG_DIR, "csrc", "deform_common.cuh"))
