"""Port parity, network: each module of ``mxdetection_tpu_torch.models``
against its flax module through ``utils/convert.py``, and the whole Faster
R-CNN slice against the frozen JAX fixture, on the CPU in float32.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxdetection_tpu.config import load_config
from mxdetection_tpu.models import layers as jlayers
from mxdetection_tpu.models.backbones.resnet import Bottleneck as JBottleneck
from mxdetection_tpu.models.backbones.resnet import ResNet as JResNet
from mxdetection_tpu.models.heads.bbox_head import BBoxHead as JBBoxHead
from mxdetection_tpu.models.heads.rpn import RPNHead as JRPNHead
from mxdetection_tpu.models.necks.fpn import FPN as JFPN
from mxdetection_tpu.models.registry import build_detector as jax_build_detector

from mxdetection_tpu_torch.models import layers as tlayers
from mxdetection_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_postprocess
from mxdetection_tpu_torch.models.heads.bbox_head import BBoxHead
from mxdetection_tpu_torch.models.heads.rpn import RPNHead
from mxdetection_tpu_torch.models.necks.fpn import FPN
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.utils.convert import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def init_flax(module, *args, seed=0):
    """flax variables as nested numpy dicts, FrozenBN statistics randomised
    (the flax init leaves them at identity, which would test nothing)."""
    variables = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed), *args))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed)

    def rand_stats(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                rand_stats(v)
            elif k in ("gamma", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)

    rand_stats(variables.get("batch_stats", {}))
    return variables


def assert_rel_close(got, ref, rtol):
    """|got - ref| <= rtol * max|ref|: f32 convs sum in another order than XLA."""
    got, ref = N(got), N(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def nchw(x):
    return T(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- layers


def test_frozen_batchnorm():
    x = np.random.RandomState(0).randn(2, 5, 6, 8).astype(np.float32)
    jm = jlayers.FrozenBatchNorm(dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(tlayers.FrozenBatchNorm(8), v)
    got = m(nchw(x)).permute(0, 2, 3, 1)
    # rsqrt: XLA's CPU rsqrt is ~1 ulp off the correctly rounded torch.rsqrt
    np.testing.assert_allclose(N(got), N(jm.apply(v, x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,dilation", [(3, 1, 1), (3, 2, 1), (1, 2, 1), (3, 1, 2)])
def test_conv_helper(kernel, stride, dilation):
    x = np.random.RandomState(1).randn(2, 9, 11, 6).astype(np.float32)
    jm = jlayers.conv(10, kernel, stride, dilation=dilation, dtype=F32, use_bias=True)
    v = init_flax(jm, x)
    m = load_flax_variables(tlayers.conv(6, 10, kernel, stride, dilation=dilation,
                                         use_bias=True), v)
    got = m(nchw(x)).permute(0, 2, 3, 1)
    assert_rel_close(got, jm.apply(v, x), 1e-5)


# ---------------------------------------------------------------- backbone / neck / heads


@pytest.mark.parametrize("in_ch,stride", [(8, 1), (16, 1), (8, 2)])
def test_bottleneck(in_ch, stride):
    x = np.random.RandomState(2).randn(2, 8, 10, in_ch).astype(np.float32)
    norm = jlayers.make_norm("frozen_bn", dtype=F32)
    jm = JBottleneck(channels=4, stride=stride, norm=norm, dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(Bottleneck(in_ch, 4, stride), v)
    assert (m.downsample_conv is None) == ("downsample_conv" not in v["params"])
    got = m(nchw(x)).permute(0, 2, 3, 1)
    assert_rel_close(got, jm.apply(v, x), 1e-5)


def test_resnet50():
    x = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    jm = JResNet(depth=50, train=False, dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(ResNet(depth=50), v)
    with torch.no_grad():
        got = m(T(x))
    ref = jm.apply(v, x)
    for g, r in zip(got, ref):
        assert_rel_close(g, r, 1e-4)


def test_fpn():
    rng = np.random.RandomState(4)
    widths = (8, 16, 24, 32)
    feats = [rng.randn(2, 32 >> i, 40 >> i, c).astype(np.float32) for i, c in enumerate(widths)]
    jm = JFPN(out_channels=16, dtype=F32)
    v = init_flax(jm, feats)
    m = load_flax_variables(FPN(out_channels=16, in_channels=widths), v)
    got = m([T(f) for f in feats])
    ref = jm.apply(v, feats)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert_rel_close(g, r, 1e-5)


def test_rpn_head():
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, 16 >> i, 20 >> i, 16).astype(np.float32) for i in range(5)]
    jm = JRPNHead(num_anchors=3, channels=16, dtype=F32)
    v = init_flax(jm, feats)
    m = load_flax_variables(RPNHead(3, 16), v)
    got = m([T(f) for f in feats])
    ref = jm.apply(v, feats)
    for gl, rl in zip(got, ref):
        for g, r in zip(gl, rl):
            assert_rel_close(g, r, 1e-5)


@pytest.mark.parametrize("agnostic", [False, True])
def test_bbox_head(agnostic):
    x = np.random.RandomState(6).randn(12, 7, 7, 16).astype(np.float32)
    jm = JBBoxHead(num_classes=5, fc_channels=32, class_agnostic=agnostic, dtype=F32)
    v = init_flax(jm, x)
    m = load_flax_variables(BBoxHead(7 * 7 * 16, 5, 32, class_agnostic=agnostic), v)
    got = m(T(x))
    for g, r in zip(got, jm.apply(v, x)):
        assert g.dtype == torch.float32
        assert_rel_close(g, r, 1e-5)


# ---------------------------------------------------------------- the slice


def fixture_cfg(name="faster_rcnn_r50_fpn_1x"):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_detector_fixtures import shrink

    return shrink(load_config(os.path.join(REPO, f"configs/{name}.py")))


@pytest.mark.parametrize("name", ["faster_rcnn_r50_fpn_1x", "mask_rcnn_r50_fpn_1x"])
def test_detector_reproduces_jax_fixture(name):
    """Converted ``PRNGKey(7)`` params reproduce ``detector_<name>.npz``
    (read only, never written). Mask R-CNN's detections are Faster R-CNN's
    (its fixture equals Faster's bit for bit): the mask branch runs on them
    afterwards (``test_torch_port_mask.py``), but its parameters must load.

    Scores, labels and valid match at rtol/atol 1e-4 (they agree exactly).
    Boxes are held at an absolute 0.05 px, rtol 0: the random-weight net
    carries activations of ~1e3 and box deltas of ~20, so the last-bit
    differences of f32 convolutions summed in another order than XLA's
    grow to a few hundredths of a pixel (0.023 px at most here). Fed the
    JAX stage's input, each stage agrees to a few 1e-6 relative (the module
    tests above), and the same weights run in float64 land 0.032 px from
    the fixture, further than the f32 port: at 1e-4 the boxes would test
    XLA's summation order, not the detector. A decode or clip error of a
    tenth of a pixel fails.
    """
    from test_detector_fixtures import HW, synthetic_image

    cfg = fixture_cfg(name)
    jb = jax_build_detector(cfg)
    images = np.asarray(synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[HW[0], HW[1], 1.0]], np.float32)
    tb = {"images": jnp.asarray(images), "im_info": jnp.asarray(im_info),
          "gt_boxes": jnp.zeros((1, 8, 4)), "gt_labels": jnp.zeros((1, 8), jnp.int32),
          "gt_valid": jnp.zeros((1, 8), bool)}
    if cfg.mask_head is not None:
        tb["box_masks"] = jnp.zeros((1, 8, 28, 28), jnp.uint8)
    variables = jax.device_get(jax.jit(jb.init)(jax.random.PRNGKey(7), tb))

    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    out = model.forward_test(T(images), T(im_info))
    dets = rcnn_postprocess(out, cfg, HW, T(im_info))

    ref = np.load(os.path.join(REPO, f"tests/fixtures/detector_{name}.npz"))
    v = N(dets["valid"][0])
    got = {"boxes": N(dets["boxes"][0]) * v[:, None], "scores": N(dets["scores"][0]) * v,
           "labels": N(dets["labels"][0]) * v, "valid": v.astype(np.int32)}
    for k in ("scores", "labels", "valid"):
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k].astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
    assert v.sum() == 20


def test_build_detector_rejects_unported():
    """Every zoo detector is ported; a ``cfg.detector`` the registry does
    not know raises, in ``build_detector`` and in ``detector_fns``."""
    from mxdetection_tpu_torch.models.registry import detector_fns

    cfg = load_config(os.path.join(REPO, "configs/rfcn_r50_1x.py")).override(detector="yolo")
    with pytest.raises(ValueError, match="unknown detector 'yolo'"):
        build_detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown detector 'yolo'"):
        detector_fns(cfg)


def test_port_runs_without_jax(tmp_path):
    """The port imports and runs a tiny seeded forward, one training step
    (saved and restored by a checkpoint; the parallel helpers
    single-process), a tiny Mask R-CNN forward with its mask probabilities
    and training step, a tiny cascade forward and training step (DCN in
    stage 4, so the deformable conv's backward runs), and a tiny RetinaNet
    and R-FCN forward and training step each, through the registry's
    postprocess, with jax, flax, optax and the JAX package blocked: the
    card's machine has no jax, and the port keeps its own configs."""
    script = textwrap.dedent("""
        import sys
        for blocked in ("jax", "flax", "optax", "mxdetection_tpu"):
            sys.modules[blocked] = None
        import torch
        torch.set_num_threads(1)  # the suite's other workers share these cores
        from mxdetection_tpu_torch.config import load_config
        from mxdetection_tpu_torch.data.transforms import batch_transform
        from mxdetection_tpu_torch.models.detectors.rcnn import mask_probs, rcnn_postprocess
        from mxdetection_tpu_torch.models.detectors import retinanet, rfcn
        from mxdetection_tpu_torch.models.registry import build_detector, detector_fns
        from mxdetection_tpu_torch.ops import psroi
        from mxdetection_tpu_torch.ops.cuda import build, deform_conv, iou, nms, roi_align
        from mxdetection_tpu_torch.parallel.dist import all_gather_objects
        from mxdetection_tpu_torch.parallel.mesh import data_parallel_size, initialize_multihost
        from mxdetection_tpu_torch.train.checkpoint import CheckpointManager
        from mxdetection_tpu_torch.train.trainer import Trainer
        from mxdetection_tpu_torch.utils import convert

        small = {
            "data.pad_h": 128, "data.pad_w": 160, "data.scale": 120, "data.max_size": 160,
            "backbone.dtype": "float32", "rpn.pre_nms_top_n_test": 100,
            "rpn.post_nms_top_n_test": 50, "test.pre_nms_per_class": 100,
            "test.max_per_image": 10, "rpn.pre_nms_top_n_train": 100,
            "rpn.post_nms_top_n_train": 50, "bbox_head.num_samples": 16}
        cfg = load_config("configs/faster_rcnn_r50_fpn_1x.py").override(**small)
        d = cfg.data
        g = torch.Generator().manual_seed(0)
        raw = torch.randint(0, 256, (2, 100, 150, 3), generator=g, dtype=torch.uint8)
        hw = torch.tensor([[100.0, 150.0], [90.0, 120.0]])
        tb = batch_transform(raw, hw, torch.tensor([False, True]), torch.zeros(2, 4, 4),
                             out_hw=(d.pad_h, d.pad_w), scale_size=d.scale,
                             max_size=d.max_size, mean=d.mean, std=d.std,
                             dtype=torch.float32)
        model = build_detector(cfg, device="cpu", seed=0)
        dets = rcnn_postprocess(model.forward_test(tb["images"], tb["im_info"]), cfg,
                                (d.pad_h, d.pad_w), tb["im_info"])
        assert torch.isfinite(dets["boxes"]).all()
        assert int(dets["valid"].sum()) > 0
        gtb = torch.tensor([[[10.0, 10.0, 60.0, 50.0]] * 3] * 2)
        trainer = Trainer(cfg, device="cpu", seed=0)
        m = trainer.run_step({
            "raw": raw, "hw": hw, "flip": torch.tensor([False, True]), "gt_boxes": gtb,
            "gt_labels": torch.zeros(2, 3, dtype=torch.int64),
            "gt_valid": torch.tensor([[True, False, False]] * 2)})
        assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
        mcfg = load_config("mask_rcnn_r50_fpn_1x").override(**small)
        model = build_detector(mcfg, device="cpu", seed=0)
        out = model.forward_test(tb["images"], tb["im_info"])
        mdets = rcnn_postprocess(out, mcfg, (d.pad_h, d.pad_w), tb["im_info"])
        probs = mask_probs(model, out, mdets, tb["im_info"])
        assert probs.shape == (2, 10, 28, 28) and torch.isfinite(probs).all()
        m = Trainer(mcfg, device="cpu", seed=0).run_step({
            "raw": raw, "hw": hw, "flip": torch.tensor([False, True]), "gt_boxes": gtb,
            "gt_labels": torch.zeros(2, 3, dtype=torch.int64),
            "gt_valid": torch.tensor([[True, False, False]] * 2),
            "box_masks": torch.ones(2, 3, 28, 28, dtype=torch.uint8)})
        assert torch.isfinite(m["loss"]) and float(m["loss_mask"]) > 0
        initialize_multihost()
        assert all_gather_objects(1) == [1] and data_parallel_size((-1, 1)) == 1
        ckpt = CheckpointManager(sys.argv[1])
        assert ckpt.save(trainer) and ckpt.restore(trainer) == 1
        casc = load_config("cascade_rcnn_r101_dcn_1x").override(**{
            "data.pad_h": 128, "data.pad_w": 160, "data.scale": 120, "data.max_size": 160,
            "backbone.depth": 50, "backbone.dtype": "float32",
            "backbone.dcn_stages": (False, False, False, True),
            "rpn.pre_nms_top_n_test": 100, "rpn.post_nms_top_n_test": 50,
            "test.pre_nms_per_class": 100, "test.max_per_image": 10})
        model = build_detector(casc, device="cpu", seed=0)
        dets = rcnn_postprocess(model.forward_test(tb["images"], tb["im_info"]), casc,
                                (d.pad_h, d.pad_w), tb["im_info"])
        assert torch.isfinite(dets["boxes"]).all() and int(dets["valid"].sum()) > 0
        m = Trainer(casc.override(**{"rpn.pre_nms_top_n_train": 100,
                                     "rpn.post_nms_top_n_train": 50,
                                     "bbox_head.num_samples": 16}), device="cpu",
                    seed=0).run_step({
            "raw": raw, "hw": hw, "flip": torch.tensor([False, True]), "gt_boxes": gtb,
            "gt_labels": torch.zeros(2, 3, dtype=torch.int64),
            "gt_valid": torch.tensor([[True, False, False]] * 2)})
        assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
        assert "loss_rcnn_cls2" in m
        batch = {"raw": raw, "hw": hw, "flip": torch.tensor([False, True]), "gt_boxes": gtb,
                 "gt_labels": torch.zeros(2, 3, dtype=torch.int64),
                 "gt_valid": torch.tensor([[True, False, False]] * 2)}
        for name, extra in (("retinanet_r50_fpn_1x", {}),
                            ("rfcn_r50_1x", {"rpn.pre_nms_top_n_test": 100,
                                             "rpn.post_nms_top_n_test": 50,
                                             "rpn.pre_nms_top_n_train": 100,
                                             "rpn.post_nms_top_n_train": 50,
                                             "bbox_head.num_samples": 16,
                                             "bbox_head.ohem_keep": 8})):
            zcfg = load_config(name).override(**{
                "data.pad_h": 128, "data.pad_w": 160, "data.scale": 120,
                "data.max_size": 160, "backbone.dtype": "float32",
                "test.pre_nms_per_class": 100, "test.max_per_image": 10,
                # seeded random weights score every class near its prior
                # (0.0099 and 1/81), under the default threshold of 0.05
                "test.score_thr": 0.0, **extra})
            model = build_detector(zcfg, device="cpu", seed=0)
            dets = detector_fns(zcfg).postprocess(
                model.forward_test(tb["images"], tb["im_info"]), zcfg, (d.pad_h, d.pad_w),
                tb["im_info"])
            assert torch.isfinite(dets["boxes"]).all() and int(dets["valid"].sum()) > 0
            m = Trainer(zcfg, device="cpu", seed=0).run_step(batch)
            assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, (name, m)
        counts = (roi_align.launch_count, roi_align.bwd_launch_count, nms.launch_count,
                  iou.launch_count, deform_conv.launch_count, deform_conv.s2_launch_count,
                  deform_conv.wgrad_launch_count, deform_conv.wgrad_s2_launch_count,
                  deform_conv.col2im_launch_count, deform_conv.col2im_s2_launch_count)
        assert all(c.n == 0 for c in counts)
        assert not any(m.split(".")[0] in ("jax", "flax", "optax", "mxdetection_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok", int(dets["valid"].sum()))
    """)
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "mxdetection_tpu_torch"])
def test_imports_stay_in_the_port(path):
    """Neither ``chip_smoke.py`` nor any module of the port names jax, flax,
    optax or any module of the JAX package: the port keeps its own copies."""
    root = os.path.join(REPO, path)
    files = ([root] if root.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")])
    assert len(files) > 1 or path.endswith(".py")
    if path == "mxdetection_tpu_torch":
        names = {os.path.relpath(f, root) for f in files}
        assert {"parallel/mesh.py", "parallel/dist.py", "train/checkpoint.py"} <= names
    for f in files:
        for mod in imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "mxdetection_tpu"), (f, mod)
