"""Port parity, Mask R-CNN: the mask head, the mask targets, the mask BCE,
the training step and the per-detection mask probabilities of
``mxdetection_tpu_torch`` against the JAX package on the CPU, in float32.

The training step is held against ``trainstep_mask_rcnn_r50_fpn_1x.npz``
(read only) from converted ``PRNGKey(7)`` variables and the JAX draws
(``jax_draws``); ``mask_probs`` against the JAX ``mask_forward``, class
slice and sigmoid, run live on the fixture image with the same variables.
On the CPU every port function runs its plain version (RoIAlign at 14x14
included); ``chip_smoke.py`` holds the kernels against those on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.losses import losses as jloss
from mxdetection_tpu.models.heads.bbox_head import MaskHead as JMaskHead
from mxdetection_tpu.models.registry import build_detector as jax_build_detector
from mxdetection_tpu.ops import mask_target as jmt

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.losses import losses as tloss
from mxdetection_tpu_torch.models import layers as tlayers
from mxdetection_tpu_torch.models.detectors.rcnn import mask_probs, rcnn_loss, rcnn_postprocess
from mxdetection_tpu_torch.models.heads.bbox_head import MaskHead
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops import mask_target as tmt
from mxdetection_tpu_torch.ops.cuda import roi_align as roi_cuda
from mxdetection_tpu_torch.utils.convert import flax_to_state_dict, load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_detector_fixtures as det_fx  # noqa: E402
import test_train_fixtures as train_fx  # noqa: E402
from test_torch_port_train import _grad_norm, jax_draws, one_torch_thread  # noqa: E402,F401

MASK = "mask_rcnn_r50_fpn_1x"


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def flax_vars(module, *args, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax.device_get(module.init(jax.random.PRNGKey(seed), *args)))


# ---------------------------------------------------------------- the head


@pytest.mark.parametrize("num_convs", [0, 2])
def test_mask_head_matches_flax(num_convs):
    """8 input channels into a 16-channel head: with no conv the deconv
    itself is 8 -> 16, so a kernel converted without the transpose fails on
    its shape; with two convs it is 16 -> 16, where only the spatial flip
    tells the conversions apart (an unflipped kernel loads, and is wrong)."""
    x = np.random.RandomState(0).randn(5, 7, 7, 8).astype(np.float32)
    jm = JMaskHead(num_classes=3, num_convs=num_convs, channels=16, dtype=jnp.float32)
    v = flax_vars(jm, x)
    v["params"]["mask_pred"]["kernel"] = v["params"]["mask_pred"]["kernel"] * 500.0
    m = load_flax_variables(MaskHead(8, 3, num_convs, 16), v)
    got = m(T(x))
    ref = N(jm.apply(v, x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (5, 14, 14, 3)
    np.testing.assert_allclose(N(got), ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    sd = flax_to_state_dict(v)  # no model: the kernel is taken for a conv's
    if num_convs == 0:
        with pytest.raises(RuntimeError, match="size mismatch"):
            MaskHead(8, 3, num_convs, 16).load_state_dict(sd)
    else:
        wrong = MaskHead(8, 3, num_convs, 16)
        wrong.load_state_dict(sd)
        assert np.abs(N(wrong(T(x))) - ref).max() > 1e-2 * np.abs(ref).max()


def test_conv_transpose_follows_flax_init_and_dtype():
    """The transposed conv's he_normal counts in-channels x kh x kw, as flax
    does for a (kh, kw, in, out) kernel, not ``w[0].numel()`` (out x kh x
    kw): at 8 -> 64 channels the two stds differ by sqrt(8). The layer
    computes in its input's dtype and keeps f32 weights."""
    x = np.zeros((1, 3, 3, 8), np.float32)
    ref = flax_vars(nn.ConvTranspose(64, (2, 2), strides=(2, 2), dtype=jnp.float32,
                                     kernel_init=nn.initializers.he_normal()), x)
    ref_std = float(np.std(ref["params"]["kernel"]))
    layer = tlayers.ConvTranspose2d(8, 64, 2, stride=2)
    tlayers.init_layer_(layer, "he_normal", torch.Generator().manual_seed(0))
    std = float(layer.weight.detach().std())
    assert abs(std / ref_std - 1) < 0.1 and abs(ref_std / np.sqrt(2 / 32) - 1) < 0.1
    assert float(layer.bias.abs().max()) == 0.0
    y = layer(torch.randn(1, 8, 3, 3, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 64, 6, 6)
    assert layer.weight.dtype == torch.float32


# ---------------------------------------------------------------- targets and loss


def _target_case():
    """Gt boxes with ragged masks, one degenerate (width < 1e-3); rois across,
    outside, inside and around them, some matched gt repeated."""
    rng = np.random.RandomState(1)
    g, r = 5, 40
    masks = (rng.rand(2, g, 28, 28) > 0.5).astype(np.uint8)
    masks[:, :, 4:20, 6:22] = 1
    gt = np.asarray([[20.0, 30, 120, 90], [60, 10, 75, 140], [5, 5, 200, 160],
                     [40, 40, 40.0004, 90], [0, 0, 1, 1]], np.float32)
    gt = np.stack([gt, gt[::-1] + 3.0])
    matched = rng.randint(0, g, (2, r)).astype(np.int32)
    matched[:, :6] = 3                      # the degenerate gt, repeatedly
    matched[:, 6:12] = 0
    base = gt[np.arange(2)[:, None], matched]
    jitter = rng.randn(2, r, 4).astype(np.float32) * 25.0
    rois = base + jitter
    rois[:, 12:16] = [[-300, -300, -200, -250]]               # outside every gt
    rois[:, 16:20] = base[:, 16:20] + [5.0, 5.0, -5.0, -5.0]  # inside
    rois[:, 20:24] = base[:, 20:24] + [-30.0, -30.0, 30.0, 30.0]  # around
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2] + 1.0)
    return masks, gt, rois.astype(np.float32), matched


def test_mask_targets_match_jax():
    """Crops within 1e-6 and binarized targets equal, image by image
    against the JAX ``crop_box_mask`` (vmapped) and ``mask_targets_for_rois``."""
    masks, gt, rois, matched = _target_case()
    got = tmt.mask_targets_for_rois(T(masks), T(gt), T(rois), T(matched), out_size=28)
    b, r = matched.shape
    idx = T(matched).long()
    crops = tmt.crop_box_masks(
        torch.gather(T(masks), 1, idx[..., None, None].expand(b, r, 28, 28)),
        torch.gather(T(gt), 1, idx[..., None].expand(b, r, 4)), T(rois), 28)
    assert got.shape == (2, 40, 28, 28) and got.dtype == torch.float32
    for i in range(2):
        ref = jmt.mask_targets_for_rois(masks[i], gt[i], rois[i], matched[i], out_size=28)
        np.testing.assert_array_equal(N(got[i]), N(ref))
        ref_crops = jax.vmap(lambda bm, gb, ro: jmt.crop_box_mask(bm, gb, ro, 28))(
            masks[i][matched[i]].astype(np.float32), gt[i][matched[i]], rois[i])
        np.testing.assert_allclose(N(crops[i]), N(ref_crops), rtol=0, atol=1e-6)
    t = N(got)
    assert t[:, 12:16].max() == 0.0 and t[:, 16:24].max() == 1.0 and 0 < t.mean() < 1


def test_mask_bce_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 64, 28, 28) * 4).astype(np.float32)
    tgt = (rng.rand(3, 64, 28, 28) > 0.4).astype(np.float32)
    valid = rng.rand(3, 64) > 0.2
    valid[2] = False
    got = tloss.mask_bce_loss(T(logits), T(tgt), T(valid))
    assert got.shape == (3,) and float(got[2]) == 0.0
    for i in range(3):
        ref = float(jloss.mask_bce_loss(logits[i], tgt[i], valid[i]))
        assert abs(float(got[i]) - ref) <= 1e-6 * max(abs(ref), 1.0), (i, float(got[i]), ref)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def mask_rcnn():
    """The shrunk Mask R-CNN of the train-step fixture in both packages, its
    batch (with ``box_masks``) and the JAX ``PRNGKey(7)`` variables, numpy."""
    path = os.path.join(REPO, f"configs/{MASK}.py")
    jcfg = train_fx.shrink(jax_load_config(path))
    bundle = jax_build_detector(jcfg)
    tb = train_fx.synthetic_batch(jcfg)
    variables = jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb))
    return jcfg, train_fx.shrink(load_config(path)), tb, variables


def test_train_step_reproduces_mask_fixture(mask_rcnn):
    """One forward + backward from the converted variables, the fixture's
    batch and the JAX ``PRNGKey(13)`` draws reproduces
    ``trainstep_mask_rcnn_r50_fpn_1x.npz`` (loss_mask 1.0693, gnorm_mask_head
    223.18) at the Faster train fixture's bounds: 2e-5 relative on the
    losses, 6e-5 on the grad norms, the discrete metrics exact (measured
    on the CPU: losses within 2.1e-6, loss_mask 6.7e-7, grad norms 2.9e-5
    at the FPN's and 1.9e-6 at the mask head's). The mask branch adds its
    gradient to the backbone's and the FPN's through RoIAlign 14x14."""
    _, tcfg, tb, variables = mask_rcnn
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    draws = jax_draws(jax.random.PRNGKey(13))
    out = model.forward_train(ttb, draws)
    assert out["mask_logits"].shape == (2, 8, 28, 28, 80)
    loss, metrics = rcnn_loss(out, ttb, draws, tcfg)
    loss.backward()

    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    for mod in ("backbone", "fpn", "rpn", "bbox_head0", "mask_head"):
        got[f"gnorm_{mod}"] = _grad_norm(getattr(model, mod).parameters())
    ref = np.load(os.path.join(REPO, f"tests/fixtures/trainstep_{MASK}.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0"):
            assert got[k] == r, k
        else:
            rtol = 6e-5 if "norm" in k else 2e-5
            assert abs(got[k] - r) <= rtol * abs(r), (k, got[k], r)


def test_mask_probs_match_live_jax(mask_rcnn):
    """``mask_probs`` of the port's detections on the detector fixture's
    image against the JAX evaluator's mask lines (``mask_forward`` on the
    scaled detections, the label's slice, sigmoid), run on the same
    variables: 1e-4 absolute on every detection's 28x28 probabilities. The
    JAX branch takes the port's detections (so both crop the same boxes)
    and the pyramid of its own ``forward_test``."""
    _, _, _, variables = mask_rcnn
    path = os.path.join(REPO, f"configs/{MASK}.py")
    jcfg = det_fx.shrink(jax_load_config(path))
    tcfg = det_fx.shrink(load_config(path))
    bundle = jax_build_detector(jcfg)
    images = np.asarray(det_fx.synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[det_fx.HW[0], det_fx.HW[1], 1.0]], np.float32)

    model = load_flax_variables(build_detector(tcfg, device="cpu"), variables)
    out = model.forward_test(T(images), T(im_info))
    dets = rcnn_postprocess(out, tcfg, det_fx.HW, T(im_info))
    got = mask_probs(model, out, dets, T(im_info))
    assert got.shape == (1, 20, 28, 28) and int(dets["valid"].sum()) == 20

    # jitted: op by op the JAX forward takes several times its compile
    jout = jax.jit(bundle.apply_eval)(variables, {"images": jnp.asarray(images),
                                                  "im_info": jnp.asarray(im_info)})
    logits = jax.jit(lambda v, p, b, ok: bundle.model_eval.apply(
        v, p, b, ok, method=bundle.model_eval.mask_forward))(
        variables, jout["pyramid"], jnp.asarray(N(dets["boxes"])) * im_info[:, 2][:, None, None],
        jnp.asarray(N(dets["valid"])))
    cls_idx = jnp.clip(jnp.asarray(N(dets["labels"])), 0, jcfg.bbox_head.num_classes - 1)
    ref = jax.nn.sigmoid(jnp.take_along_axis(
        logits, cls_idx[:, :, None, None, None], axis=-1)[..., 0])
    np.testing.assert_allclose(N(got), N(ref), rtol=0, atol=1e-4)
    assert 0.0 < float(got.min()) and float(got.max()) < 1.0


# ---------------------------------------------------------------- K3's stage at P = 14


def test_roi_stage_model_counts_unstaged_pairs():
    """``roi_stage_pairs``, the model of which (roi, tile) pairs of K3 do
    not fit its shared-memory stage and read g from global memory: at P = 7
    every pair of the main path fits; at P = 14 a roi whose 196 bins all
    lie in reach of one 8x4 tile does not (196 bins x 256 channels x 2
    bytes > 52 KiB), a large roi spread over many tiles does. Pairs and the
    longest list are ``roi_tile_pairs``'."""
    shapes, strides = [(208, 336), (104, 168)], (4, 8)
    rois = torch.tensor([[[100.0, 100, 112, 112],    # 3 x 3 cells on P2
                          [10.0, 10, 300, 250],      # a large roi on P2
                          [400.0, 200, 410, 208]]])  # 2.5 x 2 cells
    levels = torch.zeros((1, 3), dtype=torch.int32)
    valid = torch.ones((1, 3), dtype=torch.bool)
    for p, want in ((7, {0, 1, 2}), (14, {1})):
        taps = roi_cuda.roi_sample_taps(rois, levels, shapes, strides, output_size=p)
        fp = roi_cuda.roi_footprints(taps, valid)
        pairs, longest, unstaged, rois_unstaged = roi_cuda.roi_stage_pairs(
            taps, fp, levels, shapes, channels=256, itemsize=2, sampling_ratio=2)
        assert (pairs, longest) == roi_cuda.roi_tile_pairs(fp, levels, shapes)
        staged_rois = {i for i in range(3) if not bool(rois_unstaged[0, i])}
        assert staged_rois == want, (p, rois_unstaged)
        assert (unstaged == 0) == (p == 7)


def test_mask_rcnn_defaults_to_the_card():
    """``build_detector`` and ``Trainer`` build Mask R-CNN on the card unless
    asked for the CPU: here, without one, they raise; on the CPU the model
    has its mask head, stored in the compute dtype at ``train=False``."""
    from mxdetection_tpu_torch.train.trainer import Trainer

    cfg = load_config(MASK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_detector(cfg, device="cpu")
    assert {p.dtype for p in model.mask_head.parameters()} == {torch.bfloat16}
    assert model.mask_head.mask_deconv.weight.shape == (256, 256, 2, 2)
