"""Port parity, serving export: the registered operators of
``mxdetection_tpu_torch/ops/library.py`` and the export tool
``mxdetection_tpu_torch/tools/export.py``, on the CPU.

- Each operator's CPU implementation is its plain version bit for bit, and
  ``torch.library.opcheck`` passes (schema, shape function, autograd
  registration, tracing).
- The shrunk Faster R-CNN (``test_detector_fixtures.shrink``, converted
  ``PRNGKey(7)`` params) exported, saved, and loaded in another process
  with jax blocked and no module of the port's models imported, serves
  what the JAX tool's ``build_serving_fn`` serves on the same params
  (boxes 0.05 px absolute, as the detector fixture test and for its reason;
  scores, labels and valid 1e-4); its graph calls ``mxdet::roi_align``
  once, ``mxdet::nms_mask_sorted`` twice and ``mxdet::frozen_bn_act`` 49
  times.
- The shrunk Cascade R-CNN (R50 depth, DCN in stage 4, seeded offset
  convs) calls ``mxdet::deform_conv2d`` once per DCN layer, and the loaded
  artifact equals the eager port bit for bit.
- The CLI exports on the CPU with ``--device cpu`` and asks for the card
  without it.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.models.registry import build_detector as jax_build_detector

from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops import library
from mxdetection_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_backward
from mxdetection_tpu_torch.ops.nms import nms_mask_sorted_plain
from mxdetection_tpu_torch.ops.roi_align import multilevel_roi_align_plain
from mxdetection_tpu_torch.tools import export as texport
from mxdetection_tpu_torch.tools.common import (dcn_layers, parse_overrides, seed_offset_convs,
                                               seeded_model)
from mxdetection_tpu_torch.utils.convert import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)
from test_detector_fixtures import synthetic_image  # noqa: E402
from test_torch_port_detector import fixture_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_HW = (200, 240)
# test_detector_fixtures.shrink of Faster R-CNN, as the command line's --override
SHRINK = ["data.pad_h=256", "data.pad_w=320", "data.scale=240", "data.max_size=320",
          "backbone.dtype='float32'", "test.max_per_image=20", "bbox_head.num_samples=32",
          "rpn.pre_nms_top_n_test=400", "rpn.post_nms_top_n_test=100",
          "test.pre_nms_per_class=200"]


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- the operators


def roi_align_case(rng):
    feats = [T(rng.randn(2, h, w, 8).astype(np.float32)) for h, w in ((16, 20), (8, 10))]
    xy = rng.uniform(0, 60, (2, 6, 2)).astype(np.float32)
    rois = T(np.concatenate([xy, xy + rng.uniform(2, 40, (2, 6, 2)).astype(np.float32)], -1))
    levels = T(rng.randint(0, 2, (2, 6)).astype(np.int32))
    valid = T(rng.rand(2, 6) > 0.2)
    return (library.roi_align, (feats, rois, levels, valid, [4, 8], 7, 2),
            lambda: multilevel_roi_align_plain(feats, rois, [4, 8], levels, output_size=7,
                                               sampling_ratio=2, roi_valid=valid))


def nms_case(rng):
    xy = rng.uniform(0, 50, (3, 40, 2)).astype(np.float32)
    boxes = T(np.concatenate([xy, xy + rng.uniform(1, 20, (3, 40, 2)).astype(np.float32)], -1))
    valid = T(rng.rand(3, 40) > 0.1)
    return (library.nms_mask_sorted, (boxes, valid, 0.5),
            lambda: nms_mask_sorted_plain(boxes, valid, 0.5))


def deform_case(stride, radius):
    def case(rng):
        x = T(rng.randn(2, 9, 11, 8).astype(np.float32))
        ho, wo = -(-9 // stride), -(-11 // stride)
        off = T((rng.randn(2, ho, wo, 18) * 1.5).astype(np.float32))
        w = T((rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32))
        return (library.deform_conv, (x, off, w, stride, 1, radius),
                lambda: deform_conv2d(x, off, w, stride=stride, dilation=1, radius=radius))
    return case


OP_CASES = {"roi_align": roi_align_case, "nms_mask_sorted": nms_case,
            "deform_conv2d": deform_case(1, None), "deform_conv2d_s2_radius": deform_case(2, 3.0)}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_operator_cpu_is_plain_and_passes_opcheck(name):
    """The operator on CPU tensors is its plain version bit for bit, and
    ``opcheck`` passes: the schema, the shape function against the CPU
    implementation, the autograd registration and AOT tracing."""
    op, args, plain = OP_CASES[name](np.random.RandomState(0))
    got = op(*args)
    torch.testing.assert_close(got, plain(), rtol=0, atol=0)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", ["roi_align", "deform_conv2d"])
def test_operator_gradients(name):
    """The registered backward on the CPU, bit for bit: RoIAlign's is
    autograd of the plain version (the features only), as before it was an
    operator; the deformable conv's is ``deform_conv2d_backward``."""
    op, args, _ = OP_CASES[name](np.random.RandomState(1))
    leaves = list(args[0]) if name == "roi_align" else list(args[:3])
    g = torch.randn(op(*args).shape, generator=torch.Generator().manual_seed(2))

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in leaves]
        fn(ins).backward(g)
        return [t.grad for t in ins]

    if name == "roi_align":
        got = grads(lambda fs: op(fs, *args[1:]))
        ref = grads(lambda fs: multilevel_roi_align_plain(fs, args[1], [4, 8], args[2],
                                                          roi_valid=args[3]))
    else:
        got = grads(lambda ins: op(*ins, *args[3:]))
        ref = deform_conv2d_backward(*args[:3], g, stride=1, dilation=1)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- the artifacts


def op_counts(program) -> dict:
    """Calls of each ``mxdet`` operator in an exported program's graph."""
    c = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    return {k.split(".")[1]: v for k, v in c.items() if k.startswith("mxdet.")}


def serving_input():
    """Two uint8 canvases of ``RAW_HW``: the fixture's synthetic images cut
    to their 200x240 region that holds both bright blobs (the second image
    to its first 180 of those rows); and their image sizes."""
    raw = np.zeros((2, *RAW_HW, 3), np.uint8)
    for i, (seed, h) in enumerate(((0, 200), (1, 180))):
        raw[i, :h] = synthetic_image(seed)[30:30 + h, 50:290].astype(np.uint8)
    return raw, np.asarray([[200.0, 240.0], [180.0, 240.0]], np.float32)


LOADER = textwrap.dedent("""
    import json
    import sys
    from collections import Counter
    for blocked in ("jax", "flax", "optax", "mxdetection_tpu"):
        sys.modules[blocked] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from mxdetection_tpu_torch.tools.export import load_serving
    inp = np.load(sys.argv[1])
    raw, hw = torch.from_numpy(inp["raw"]), torch.from_numpy(inp["hw"])
    out, ops = {}, {}
    for name in sys.argv[3:]:
        serve = load_serving(f"{sys.argv[2]}/{name}.pt2", "cpu")
        ops[name] = Counter(str(n.target) for n in serve.graph.nodes
                            if str(n.target).startswith("mxdet."))
        for k, v in zip(("boxes", "scores", "labels", "valid"), serve(raw, hw)):
            out[f"{name}_{k}"] = v.numpy()
    np.savez(f"{sys.argv[2]}/served.npz", **out)
    print(json.dumps({"ops": ops, "modules": sorted(
        m for m in sys.modules if sys.modules[m] is not None
        and m.split(".")[0] in ("jax", "mxdetection_tpu_torch"))}))
""")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Faster R-CNN exported at batch 2 by the command line (``--device
    cpu``) from a checkpoint of the converted ``PRNGKey(7)`` params, beside
    Cascade R-CNN (seeded weights and offset convs) exported here; both
    saved and served by ``LOADER`` in another process."""
    tmp = tmp_path_factory.mktemp("export")
    raw, hw = serving_input()
    np.savez(tmp / "input.npz", raw=raw, hw=hw)

    cfg = jax_load_config(os.path.join(REPO, "configs/faster_rcnn_r50_fpn_1x.py"),
                          parse_overrides(SHRINK))
    jb = jax_build_detector(cfg)
    tb = {"images": jnp.zeros((1, cfg.data.pad_h, cfg.data.pad_w, 3)),
          "im_info": jnp.asarray([[cfg.data.pad_h, cfg.data.pad_w, 1.0]]),
          "gt_boxes": jnp.zeros((1, 8, 4)), "gt_labels": jnp.zeros((1, 8), jnp.int32),
          "gt_valid": jnp.zeros((1, 8), bool)}
    variables = jax.device_get(jax.jit(jb.init)(jax.random.PRNGKey(7), tb))
    faster = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    os.makedirs(tmp / "ckpt")
    torch.save({"step": 0, "model": faster.state_dict()}, tmp / "ckpt" / "step_0.pt")
    cli = subprocess.Popen(
        [sys.executable, "-m", "mxdetection_tpu_torch.tools.export", "--config",
         "faster_rcnn_r50_fpn_1x", "--device", "cpu", "--checkpoint", str(tmp / "ckpt"),
         "--batch-size", "2", "--raw-hw", *map(str, RAW_HW), "--out", str(tmp / "faster.pt2"),
         "--override", *SHRINK], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    try:
        ccfg = fixture_cfg("cascade_rcnn_r101_dcn_1x")
        cascade = seeded_model(ccfg, "cpu")
        seed_offset_convs(cascade, ccfg, T(raw), T(hw), torch.Generator().manual_seed(11))
        program = texport.export_serving(cascade, ccfg, 2, RAW_HW)
        torch.export.save(program, tmp / "cascade.pt2")
        eager = texport.ServingModule(cascade, ccfg)(T(raw), T(hw))
        cli_out, cli_err = cli.communicate(timeout=300)
    finally:
        cli.kill()
    assert cli.returncode == 0, cli_err[-3000:]
    served = subprocess.run([sys.executable, "-c", LOADER, str(tmp / "input.npz"), str(tmp),
                             "faster", "cascade"], cwd=REPO, capture_output=True, text=True,
                            env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert served.returncode == 0, served.stderr[-3000:]
    return {"cfg": cfg, "bundle": jb, "variables": variables, "raw": raw, "hw": hw,
            "cli_stdout": cli_out, "faster_bytes": (tmp / "faster.pt2").stat().st_size,
            "cascade": program, "cascade_eager": eager,
            "cascade_dcn_layers": len(dcn_layers(cascade)),
            "loader": json.loads(served.stdout.strip().splitlines()[-1]),
            "served": dict(np.load(tmp / "served.npz"))}


def load_jax_export_tool():
    """The JAX ``tools/export.py`` as a module (it imports ``train`` from
    its own directory, as a script does)."""
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location("jax_export_tool",
                                                      os.path.join(tools, "export.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


def test_export_cli_on_the_cpu(artifacts):
    """``python -m mxdetection_tpu_torch.tools.export --device cpu`` exits
    0 with the JAX tool's summary line, and its artifact loads in a process
    that imported the operators and the export tool's module, and nothing
    of the models or of jax."""
    out = artifacts["cli_stdout"]
    assert out.startswith(f"exported {artifacts['faster_bytes']} bytes to "), out
    assert "(in: raw(2, 200, 240, 3) u8 + hw(2, 2) f32 -> boxes/scores/labels/valid)" in out
    mods = artifacts["loader"]["modules"]
    assert "mxdetection_tpu_torch.ops.library" in mods
    assert not [m for m in mods if m.startswith(("jax", "mxdetection_tpu_torch.models"))], mods


def test_exported_graphs_call_the_operators(artifacts):
    """Faster R-CNN: RoIAlign once, NMS twice (the RPN, the class-aware
    test NMS), as the loaded artifact's graph shows. Cascade: a deformable
    conv per DCN layer, RoIAlign once per stage, NMS twice. Both (R50):
    the FrozenBN epilogue 49 times, the stem's and three a block."""
    assert artifacts["loader"]["ops"]["faster"] == {"mxdet.roi_align.default": 1,
                                                    "mxdet.nms_mask_sorted.default": 2,
                                                    "mxdet.frozen_bn_act.default": 49}
    assert artifacts["loader"]["ops"]["cascade"] == {"mxdet.deform_conv2d.default": 3,
                                                     "mxdet.roi_align.default": 3,
                                                     "mxdet.nms_mask_sorted.default": 2,
                                                     "mxdet.frozen_bn_act.default": 49}
    assert artifacts["cascade_dcn_layers"] == 3
    assert op_counts(artifacts["cascade"]) == {"deform_conv2d": 3, "roi_align": 3,
                                               "nms_mask_sorted": 2, "frozen_bn_act": 49}


def test_served_faster_matches_jax_serving_fn(artifacts):
    """The Faster artifact, loaded in another process, against the JAX
    tool's ``build_serving_fn`` jitted on the same params and canvases:
    the detections of the valid rows (invalid rows zeroed on both sides, as
    the fixture test compares them), boxes at the fixture test's 0.05 px.

    The transform normalises the canvases, so the random-weight net
    saturates: its scores are 1.0 and its boxes collapse onto the image's
    border, where a box coordinate amplifies the last-bit differences of
    f32 sums (0.042 px here; on these images resampled to 200x240 instead
    of cut, one collapsed box lay 4.6 px apart, with the transforms within
    6e-7 and the scores equal)."""
    jtool = load_jax_export_tool()
    serve = jax.jit(jtool.build_serving_fn(artifacts["cfg"], artifacts["bundle"],
                                           artifacts["variables"]))
    ref = dict(zip(("boxes", "scores", "labels", "valid"),
                   jax.device_get(serve(artifacts["raw"], artifacts["hw"]))))
    got = {k: artifacts["served"][f"faster_{k}"] for k in ref}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"].astype(np.float64)
    assert v.sum(-1).min() > 0
    for k in ("scores", "labels"):
        np.testing.assert_allclose(got[k] * v, ref[k] * v, rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"] * v[..., None], ref["boxes"] * v[..., None],
                               rtol=0, atol=0.05)


def test_served_cascade_equals_eager(artifacts):
    """The loaded Cascade artifact runs the eager port's operations: its
    detections are the eager ones bit for bit."""
    for k, ref in zip(("boxes", "scores", "labels", "valid"), artifacts["cascade_eager"]):
        np.testing.assert_array_equal(artifacts["served"][f"cascade_{k}"], ref.numpy(),
                                      err_msg=k)
    assert artifacts["cascade_eager"][3].sum() > 0


def test_export_defaults_to_the_card(tmp_path):
    """Without ``--device cpu`` the tool asks for the card, as the other
    tools do, and so does ``load_serving``."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main(["--config", "faster_rcnn_r50_fpn_1x", "--out", str(tmp_path / "x.pt2")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_serving(str(tmp_path / "x.pt2"))
    assert not (tmp_path / "x.pt2").exists()
