"""Port parity, deformable convs and the cascade: ``ops/dcn.py``, the
``DeformConv`` layer and the Cascade R-CNN DCN detector of
``mxdetection_tpu_torch`` against the JAX package on the CPU, in float32,
from numpy-seeded inputs.

On the CPU the port runs its plain version (the JAX gather formulation);
the CUDA kernel (K5/K5b, ``csrc/deform_conv.cu``) cannot run here and is
held against the plain version on the card by ``chip_smoke.py``. Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.models import layers as jlayers
from mxdetection_tpu.models.backbones.resnet import Bottleneck as JBottleneck
from mxdetection_tpu.models.backbones.resnet import DeformConv as JDeformConv
from mxdetection_tpu.models.backbones.resnet import ResNet as JResNet
from mxdetection_tpu.models.registry import build_detector as jax_build_detector
from mxdetection_tpu.ops import dcn as jdcn
from mxdetection_tpu.ops.pallas.dcn import (deform_conv2d_pallas,
                                            deform_conv2d_s2_pallas_batched)

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models.backbones.resnet import Bottleneck, DeformConv, ResNet
from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_loss, rcnn_postprocess
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops import dcn as tdcn
from mxdetection_tpu_torch.ops.cuda import deform_conv as cuda_dcn
from mxdetection_tpu_torch.ops.cuda import k5_variants
from mxdetection_tpu_torch.ops.matching import TorchDraws
from mxdetection_tpu_torch.utils.convert import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

from test_torch_port_detector import N, T, assert_rel_close, init_flax, nchw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32
CASCADE = "cascade_rcnn_r101_dcn_1x"


def dcn_inputs(rng, b, h, w, c, cout, stride, std=2.0):
    """x, offsets (normal, ``std`` cells: some beyond +-3, some sampling
    outside the map) and an HWIO weight, float32."""
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, ho, wo, 18) * std).astype(np.float32)
    wt = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    return x, off, wt


def jax_gather(fn, x, off, *args, **kw):
    return np.asarray(jax.vmap(lambda xi, oi: fn(xi, oi, *args, **kw))(
        jnp.asarray(x), jnp.asarray(off)))


# ---------------------------------------------------------------- ops/dcn.py


@pytest.mark.parametrize("stride,dilation,c", [(1, 1, 8), (2, 1, 16), (1, 2, 8), (2, 2, 16)])
def test_deform_conv_matches_jax_gather(stride, dilation, c):
    """The plain version against the JAX gather path (``deform_sample_patches``
    and ``deform_conv2d``), rtol 1e-5: the same f32 operations in the same
    order, so the patches agree to rounding and the product to f32
    summation order. Offsets of std 2 cells put samples beyond +-3 and
    outside the map."""
    rng = np.random.RandomState(10 + stride + 2 * dilation)
    x, off, wt = dcn_inputs(rng, 2, 11, 13, c, 12, stride)
    assert (np.abs(off) > 3).any()
    patches = tdcn.deform_sample_patches(T(x), T(off), stride=stride, dilation=dilation)
    ref = jax_gather(jdcn.deform_sample_patches, x, off, kernel=3, stride=stride,
                     dilation=dilation)
    np.testing.assert_allclose(N(patches), ref, rtol=1e-5, atol=1e-6)
    got = tdcn.deform_conv2d(T(x), T(off), T(wt), stride=stride, dilation=dilation)
    ref = jax_gather(jdcn.deform_conv2d, x, off, jnp.asarray(wt), stride=stride,
                     dilation=dilation)
    assert got.shape == ref.shape
    np.testing.assert_allclose(N(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_radius_matches_pallas_interpret(stride):
    """``radius=3`` against the Pallas kernels (K5, K5b) in interpret mode at
    C = 128 and the shapes of ``tests/test_pallas_dcn.py``, with that file's
    tolerance, 2e-3. The Pallas kernels clamp offsets to +-3 and sum the
    bilinear terms per integer displacement, so they differ from the gather
    by rounding; offsets of std 2 cells make the clamp matter."""
    rng = np.random.RandomState(20 + stride)
    h, w = (12, 20) if stride == 1 else (22, 18)
    x, off, wt = dcn_inputs(rng, 1, h, w, 128, 128, stride)
    wt *= 0.5
    assert (np.abs(off) > 3).any()
    if stride == 1:
        ref = deform_conv2d_pallas(jnp.asarray(x[0]), jnp.asarray(off[0]), jnp.asarray(wt),
                                   interpret=True)[None]
    else:
        ref = deform_conv2d_s2_pallas_batched(jnp.asarray(x), jnp.asarray(off),
                                              jnp.asarray(wt), interpret=True)
    got = tdcn.deform_conv2d_batched(T(x), T(off), T(wt), stride=stride, radius=3)
    assert got.shape == ref.shape
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=2e-3, atol=2e-3)
    unclamped = tdcn.deform_conv2d_batched(T(x), T(off), T(wt), stride=stride)
    assert (unclamped - got).abs().max() > 0.1  # the clamp is on the path


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_zero_offsets_give_conv2d(stride, dilation):
    """Zero offsets: the plain version is ``F.conv2d`` of the same weights
    (padding = dilation), within 1e-5 of the largest output."""
    rng = np.random.RandomState(30 + stride + dilation)
    x, off, wt = dcn_inputs(rng, 2, 10, 9, 8, 16, stride)
    got = tdcn.deform_conv2d_batched(T(x), torch.zeros(T(off).shape), T(wt), stride=stride,
                                     dilation=dilation)
    ref = F.conv2d(nchw(x), T(wt).permute(3, 2, 0, 1), stride=stride, padding=dilation,
                   dilation=dilation).permute(0, 2, 3, 1)
    assert_rel_close(got, ref, 1e-5)


def test_deform_conv_dispatch():
    """CPU tensors take the plain version exactly; another device raises."""
    rng = np.random.RandomState(40)
    x, off, wt = dcn_inputs(rng, 1, 6, 7, 8, 8, 1)
    torch.testing.assert_close(tdcn.deform_conv2d_batched(T(x), T(off), T(wt)),
                               tdcn.deform_conv2d(T(x), T(off), T(wt)), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no implementation"):
        tdcn.deform_conv2d_batched(T(x).to("meta"), T(off).to("meta"), T(wt).to("meta"))


def _dcn_call(x_dtype=torch.float32, w_dtype=None, off_dtype=torch.float32, cin=64,
              cout=64, stride=1, off_shape=None, layout=False, device="cpu", hw=(6, 8)):
    h, w = hw
    x = torch.empty(1, h, w, cin, dtype=x_dtype, device=device)
    if layout:
        x = torch.zeros(1, w, h, cin, dtype=x_dtype).transpose(1, 2)
    ho, wo = -(-h // stride), -(-w // stride)
    off = torch.zeros(off_shape or (1, ho, wo, 18), dtype=off_dtype, device=device)
    wt = torch.zeros(3, 3, cin, cout, dtype=w_dtype or x_dtype, device=device)
    return lambda: cuda_dcn.deform_conv2d_cuda(x, off, wt, stride=stride)


DCN_WRAPPER_CASES = {
    "dtype": (TypeError, "dtype", _dcn_call(x_dtype=torch.float16)),
    "mixed_dtypes": (TypeError, "dtype", _dcn_call(w_dtype=torch.bfloat16)),
    "offsets_dtype": (TypeError, "offsets", _dcn_call(off_dtype=torch.bfloat16)),
    "cin": (ValueError, "Cin=48", _dcn_call(cin=48)),
    "cout": (ValueError, "Cout=96", _dcn_call(cout=96)),
    "cout_bf16": (ValueError, "Cout=64", _dcn_call(x_dtype=torch.bfloat16, cout=64)),
    "cout_bf16_not_256": (ValueError, "Cout=384", _dcn_call(x_dtype=torch.bfloat16, cout=384)),
    "x_elements_bf16": (ValueError, "elements", _dcn_call(x_dtype=torch.bfloat16, cout=128,
                                                          device="meta", hw=(2 ** 16, 2 ** 15))),
    "stride": (ValueError, "stride 3", _dcn_call(stride=3)),
    "offsets_shape": (ValueError, "offsets", _dcn_call(off_shape=(1, 6, 8, 9))),
    "layout": (ValueError, "contiguous", _dcn_call(layout=True)),
    "cpu": (ValueError, "CUDA", _dcn_call()),
}


@pytest.mark.parametrize("case", sorted(DCN_WRAPPER_CASES))
def test_deform_conv_cuda_wrapper_validates_before_launch(case, monkeypatch):
    """The kernel's wrapper refuses what the kernel does not take, and any
    tensor not on a CUDA device, before building or launching anything."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cuda_dcn, "load_library", no_build)
    exc, match, call = DCN_WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        call()


WEIGHT_TILES_CASES = {
    "dtype": (ValueError, "bf16", torch.zeros(3, 3, 64, 128)),
    "shape": (ValueError, "bf16", torch.zeros(3, 64, 128, dtype=torch.bfloat16)),
    "cin": (ValueError, "Cin=48", torch.zeros(3, 3, 48, 128, dtype=torch.bfloat16)),
    "cout": (ValueError, "Cout=64", torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)),
    "cpu": (ValueError, "CUDA", torch.zeros(3, 3, 64, 128, dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(WEIGHT_TILES_CASES))
def test_weight_tiles_cuda_validates_before_launch(case, monkeypatch):
    """The card's weight layout refuses what its kernel does not take, and a
    weight not on a CUDA device, before building or launching anything."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cuda_dcn, "load_library", no_build)
    exc, match, weight = WEIGHT_TILES_CASES[case]
    with pytest.raises(exc, match=match):
        cuda_dcn.wgmma_weight_tiles_cuda(weight)


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 256), (64, 512)])
def test_wgmma_weight_tiles_reads_back_as_documented(cin, cout):
    """The bf16 forward's layout of W (``wgmma_weight_tiles``, the plain
    version of the card's layout kernel), read back by its documented rule,
    is ``weight.reshape(9 * Cin, Cout)`` element for element: element
    (j, kc, n, 8 s + e) is W[64 kc + 8 (s ^ n % 8) + e, tile_n j + n]."""
    weight = torch.from_numpy(np.random.RandomState(cin + cout).randn(3, 3, cin, cout)
                              .astype(np.float32)).bfloat16()
    tile_n = cuda_dcn.bf16_tile_n(cout)
    assert tile_n == (128 if cout == 128 else 256)
    tiles = cuda_dcn.wgmma_weight_tiles(weight, tile_n)
    assert tiles.shape == (cout // tile_n, 9 * cin // 64, tile_n, 64) and tiles.is_contiguous()
    j, kc, n, k = np.meshgrid(*[np.arange(d) for d in tiles.shape], indexing="ij")
    read = tiles.float().numpy()[j, kc, n, ((k // 8) ^ (n % 8)) * 8 + k % 8]
    wmat = weight.reshape(9 * cin, cout).float().numpy()
    np.testing.assert_array_equal(read, wmat[64 * kc + k, tile_n * j + n])
    # the swizzle moves data: row n = 1 stores K's second 16-byte group first
    np.testing.assert_array_equal(tiles[0, 0, 1, :8].float().numpy(), wmat[8:16, 1])


def test_bf16_tile_n():
    assert [cuda_dcn.bf16_tile_n(c) for c in (64, 128, 192, 256, 384, 512, 1024)] == [
        None, 128, None, 256, None, 256, 256]


@pytest.mark.parametrize("name", sorted(k5_variants.VARIANTS))
def test_k5_variant_edits_apply(name, tmp_path):
    """Each variant that ``ops/cuda/k5_variants.py`` times on the card is one
    edit set that still applies, each edit exactly once, to the kernel
    source; only ``deform_conv.cu`` changes."""
    from mxdetection_tpu_torch.ops.cuda import build

    csrc = k5_variants.make_variant(name, build.CSRC_DIR, str(tmp_path / name))
    assert sorted(os.listdir(csrc)) == sorted(os.listdir(build.CSRC_DIR))
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as a, open(os.path.join(build.CSRC_DIR, f)) as b:
            same = a.read() == b.read()
        assert same == (f != "deform_conv.cu" or name == "base"), f


# ---------------------------------------------------------------- layers


def noisy_offsets(params, seed, std):
    """Replace every flax ``offset_conv`` kernel and bias under ``params``
    (zero-initialised, which would make DCN a plain conv) by numpy noise of
    ``std``, in place."""
    rng = np.random.RandomState(seed)
    for k, v in params.items():
        if k == "offset_conv":
            v["kernel"] = (rng.randn(*v["kernel"].shape) * std).astype(np.float32)
            v["bias"] = (rng.randn(*v["bias"].shape) * std).astype(np.float32)
        elif isinstance(v, dict):
            noisy_offsets(v, seed + 1, std)
    return params


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_layer_matches_flax(stride):
    """``DeformConv`` through ``load_flax_variables`` (kernel, offset_conv
    kernel and bias) against the flax layer with noisy offset convs."""
    x = np.random.RandomState(50).randn(2, 9, 11, 8).astype(np.float32)
    jm = JDeformConv(features=12, stride=stride, dtype=F32)
    v = init_flax(jm, x)
    noisy_offsets(v["params"], 51, std=0.5)
    m = load_flax_variables(DeformConv(8, 12, stride), v)
    offsets = m.offset_conv(nchw(x))
    assert offsets.std() > 0.5
    got = m(nchw(x)).permute(0, 2, 3, 1)
    assert_rel_close(got, jm.apply(v, x), 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_dcn_matches_flax(stride):
    x = np.random.RandomState(52).randn(2, 8, 10, 16).astype(np.float32)
    norm = jlayers.make_norm("frozen_bn", dtype=F32)
    jm = JBottleneck(channels=4, stride=stride, use_dcn=True, norm=norm, dtype=F32)
    v = init_flax(jm, x)
    noisy_offsets(v["params"], 53, std=0.3)
    m = load_flax_variables(Bottleneck(16, 4, stride, use_dcn=True), v)
    assert isinstance(m.conv2, DeformConv)
    got = m(nchw(x)).permute(0, 2, 3, 1)
    assert_rel_close(got, jm.apply(v, x), 1e-5)


# Offset-conv noise of the first (stride-2) DCN block of each stage, scaled
# to the stage's activations so the offsets have a std of 1-2 cells and
# reach about 5 cells (beyond the Pallas kernels' +-3).
STAGE_OFFSET_NOISE = {"layer2_block0": 2e-3, "layer3_block0": 5e-4, "layer4_block0": 2e-5}


def test_resnet50_dcn_matches_flax():
    """ResNet-50 with DCN in stages 2-4 against flax (eval mode, so the JAX
    layers run the gather path on the CPU), within 1e-4 of the largest
    output, as ``test_resnet50``.

    Only the first DCN of each stage gets noisy offsets; the others keep the
    zero init and sample on the grid. A random-weight net with noisy offsets
    in all 13 DCN layers is chaotic: there, a 1e-6 relative change of the
    input moves JAX's own C4 by about 17 %, and the port lands as far, so
    such a test would measure f32 summation order, not the port. Here the
    port's gap (2e-6 of the largest output) is below the 3e-6 that the
    same 1e-6 input change makes in JAX.
    """
    x = np.random.RandomState(54).randn(1, 64, 96, 3).astype(np.float32)
    dcn = (False, True, True, True)
    jm = JResNet(depth=50, dcn_stages=dcn, train=False, dtype=F32)
    v = init_flax(jm, x)
    for i, (blk, std) in enumerate(STAGE_OFFSET_NOISE.items()):
        noisy_offsets(v["params"][blk], 55 + i, std)
    m = load_flax_variables(ResNet(depth=50, dcn_stages=dcn), v)
    with torch.no_grad():
        got = m(T(x))
    for g, r in zip(got, jm.apply(v, x)):
        assert_rel_close(g, r, 1e-4)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def cascade():
    """The shrunk cascade (R50, DCN in stage 4 only, 256x320, f32) and the
    JAX ``PRNGKey(7)`` params of its detector fixture, as numpy."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_detector_fixtures import HW, shrink, synthetic_image

    cfg = shrink(jax_load_config(os.path.join(REPO, f"configs/{CASCADE}.py")))
    jb = jax_build_detector(cfg)
    images = np.asarray(synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[HW[0], HW[1], 1.0]], np.float32)
    tb = {"images": jnp.asarray(images), "im_info": jnp.asarray(im_info),
          "gt_boxes": jnp.zeros((1, 8, 4)), "gt_labels": jnp.zeros((1, 8), jnp.int32),
          "gt_valid": jnp.zeros((1, 8), bool)}
    variables = jax.device_get(jax.jit(jb.init)(jax.random.PRNGKey(7), tb))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return cfg, jb, images, im_info, variables


def port_dets(cfg, variables, images, im_info):
    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    out = model.forward_test(T(images), T(im_info))
    return rcnn_postprocess(out, cfg, tuple(images.shape[1:3]), T(im_info))


def masked(dets):
    v = N(dets["valid"][0]).astype(bool)
    return {"boxes": N(dets["boxes"][0]) * v[:, None], "scores": N(dets["scores"][0]) * v,
            "labels": N(dets["labels"][0]) * v, "valid": v.astype(np.int32)}


def assert_dets_close(got, ref):
    """The tolerances of ``test_detector_reproduces_jax_fixture``: scores,
    labels and valid at 1e-4; boxes at an absolute 0.05 px (f32 summation
    order in a random-weight net)."""
    for k in ("scores", "labels", "valid"):
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k].astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)


def test_cascade_reproduces_jax_fixture(cascade):
    """Converted ``PRNGKey(7)`` params reproduce
    ``detector_cascade_rcnn_r101_dcn_1x.npz`` (read only): three
    class-agnostic stages, stage-averaged scores. Its offset convs are
    zero-initialised, so DCN acts as a plain conv here."""
    cfg, _, images, im_info, variables = cascade
    got = masked(port_dets(cfg, variables, images, im_info))
    ref = np.load(os.path.join(REPO, f"tests/fixtures/detector_{CASCADE}.npz"))
    assert_dets_close(got, ref)
    assert got["valid"].sum() > 0


# Offset-conv noise of the cascade fixture's first stage-4 DCN: offsets of
# std 4.5 cells, up to 17.5, on the 8x10 map of its input (many corners out
# of bounds).
CASCADE_OFFSET_NOISE = 1e-3


def test_cascade_matches_live_jax_with_noisy_offsets(cascade):
    """The same detector with a noisy offset conv in its first stage-4 DCN
    layer, against the JAX ``apply_eval`` run live, with the fixture test's
    tolerances. The other two stage-4 DCN layers keep the zero init: with
    noise in all three, this random-weight net turns chaotic (a 1e-6
    relative change of the input flips labels in JAX itself). Measured gap:
    0.0067 px on the boxes, where the same 1e-6 input change moves JAX's
    boxes by 0.0023 px."""
    cfg, jb, images, im_info, variables = cascade
    variables = jax.tree_util.tree_map(np.copy, variables)
    noisy_offsets(variables["params"]["backbone"]["layer4_block0"], 56, CASCADE_OFFSET_NOISE)
    tb = {"images": jnp.asarray(images), "im_info": jnp.asarray(im_info)}
    out = jax.jit(jb.apply_eval)(variables, tb)
    ref = masked(jb.postprocess(out, cfg, tuple(images.shape[1:3]), tb["im_info"]))

    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    offsets = []
    model.backbone.layer4_block0.conv2.offset_conv.register_forward_hook(
        lambda m, i, o: offsets.append(o))
    out = model.forward_test(T(images), T(im_info))
    got = masked(rcnn_postprocess(out, cfg, tuple(images.shape[1:3]), T(im_info)))
    assert offsets[0].std() > 2.0 and offsets[0].abs().max() > 10.0
    assert_dets_close(got, ref)
    assert got["valid"].sum() > 0


def test_cascade_build_and_training_guard():
    """``build_detector`` of the cascade in eval mode stores the model in
    its compute dtype but the offset convs in f32, as the JAX layer; in
    train mode every parameter stays an f32 master weight, and a training
    step runs: three stages, and a gradient for every deformable layer's
    weight and offset conv (through ``mxdet::deform_conv2d``'s registered backward). The
    step runs with one DCN stage, stage 4 (a stride-2 and two stride-1
    layers), to keep the test short."""
    cfg = load_config(CASCADE)
    model = build_detector(cfg.override(**{"backbone.depth": 50}), device="cpu", seed=0)
    assert model.num_stages == 3 and model.class_agnostic
    assert model.bbox_head2.bbox_pred.weight.shape[0] == 4
    dcn = model.backbone.layer3_block0.conv2
    assert isinstance(dcn, DeformConv) and dcn.stride == 2
    assert not isinstance(model.backbone.layer1_block0.conv2, DeformConv)
    assert dcn.offset_conv.weight.dtype == torch.float32
    assert dcn.offset_conv.bias.dtype == torch.float32
    assert dcn.weight.dtype == torch.bfloat16
    assert float(dcn.offset_conv.weight.detach().abs().sum()) == 0.0  # zero init, as JAX
    assert len(model.backbone.block_names[2]) == 6
    assert len(load_config(CASCADE).backbone.dcn_stages) == 4
    r101 = ResNet(depth=101, dcn_stages=cfg.backbone.dcn_stages)
    assert len(r101.block_names[2]) == 23

    small = cfg.override(**{"backbone.depth": 50, "backbone.dtype": "float32",
                            "backbone.dcn_stages": (False, False, False, True),
                            "rpn.pre_nms_top_n_train": 50, "rpn.post_nms_top_n_train": 20,
                            "bbox_head.num_samples": 16})
    model = build_detector(small, device="cpu", seed=0, train=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tb = {"images": torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(0)),
          "im_info": torch.tensor([[64.0, 96.0, 1.0]]),
          "gt_boxes": torch.tensor([[[8.0, 8.0, 40.0, 50.0], [0.0, 0.0, 0.0, 0.0]]]),
          "gt_labels": torch.tensor([[3, 0]]), "gt_valid": torch.tensor([[True, False]])}
    draws = TorchDraws(torch.Generator().manual_seed(1))
    out = model.forward_train(tb, draws)
    loss, metrics = rcnn_loss(out, tb, draws, small)
    loss.backward()
    assert len(out["stages"]) == 3 and torch.isfinite(loss) and "loss_rcnn_cls2" in metrics
    layers = [m for m in model.modules() if isinstance(m, DeformConv)]
    assert len(layers) == 3 and [m.stride for m in layers] == [2, 1, 1]
    for m in layers:
        assert m.weight.grad.abs().max() > 0 and m.offset_conv.weight.grad.abs().max() > 0
