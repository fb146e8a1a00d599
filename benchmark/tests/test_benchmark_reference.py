"""The plain reference against the program at tiny shapes on the CPU (both
in float32), and the import rules: the reference imports nothing of the
program or of JAX, and a run holds no module of JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark import cell, spec
from benchmark.reference import detector as D
from benchmark.reference import infer as RI
from benchmark.reference import train as RT
from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mxdetection_tpu", "mxdetection_tpu_torch"}


def imported_roots(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_only_torch_numpy_and_itself():
    here = os.path.join(spec.HERE, "reference")
    for f in os.listdir(here):
        if f.endswith(".py"):
            assert imported_roots(os.path.join(here, f)) <= {"__future__", "contextlib", "math",
                                                             "numpy", "torch"}, f


def test_no_benchmark_file_names_jax():
    for d, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                roots = imported_roots(os.path.join(d, f))
                assert not roots & (FORBIDDEN - {"mxdetection_tpu_torch"}), (d, f)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxdetection_tpu_torch_extra", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mxdetection_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert cell.forbidden_modules() == ["flax", "mxdetection_tpu"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "faster_r50_fpn.infer_b32",
                        "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def program(name: str, seed: int = 3):
    """The tiny cell's program in float32 on the CPU, with the benchmark's
    weights, and the reference's copy of them."""
    sp = tiny.tiny_cell(name, dtype="float32")
    conf, t = sp["config"], sp["traffic"]
    cfg = cell.program_config(conf)
    pool = cell.Pool(t, seed, torch.device("cpu"), pin=False)
    train = t["mode"] == "train"
    model = cell.build_program(cfg, torch.device("cpu"), train=train)
    W = cell.make_weights(sp["family"], conf, pool, seed, torch.device("cpu"))
    model.load_state_dict(W, strict=True)
    return sp, cfg, pool, model, W


@pytest.mark.parametrize("name", ["faster_r50_fpn.infer_b32", "cascade_r101_dcn.infer_b8"])
def test_reference_inference_equals_program_in_f32(name):
    from mxdetection_tpu_torch.tools.common import infer_batch

    sp, cfg, pool, model, W = program(name)
    m = sp["config"]["model"]
    raw, hw = pool.infer_batch(0)
    slot = []
    model.rpn.register_forward_hook(lambda mod, i, o: slot.append(o))
    dets, out = infer_batch(model, cfg, raw, hw, torch.float32)
    rdets, rout, rrpn = RI.detect(W, m, raw, hw, D.F32, chunk=1)
    for p, r in zip(slot[0][0] + slot[0][1], rrpn[0] + rrpn[1]):
        assert (p - r).abs().max() <= 1e-4 * r.abs().max()
    assert torch.equal(out["roi_valid"], rout["roi_valid"])
    assert (out["rois"] - rout["rois"]).abs().max() <= 1e-2
    assert (out["probs"] - rout["probs"]).abs().max() <= 1e-5
    assert torch.equal(dets["valid"], rdets["valid"]) and dets["valid"].any()
    v = dets["valid"]
    assert torch.equal(dets["labels"][v], rdets["labels"][v])
    assert (dets["boxes"] - rdets["boxes"])[v].abs().max() <= 1e-2
    assert (dets["scores"] - rdets["scores"])[v].abs().max() <= 1e-5


@pytest.mark.parametrize("name", ["faster_r50_fpn.train_b8", "cascade_r101_dcn.train_b8"])
def test_reference_training_step_equals_program_in_f32(name):
    """The loss and the raw gradient of the program's first step, leaf by
    leaf, against the reference's, following the same draws and proposals."""
    sp, cfg, pool, model, W = program(name)
    m = sp["config"]["model"]
    from mxdetection_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, model, device="cpu", steps_per_epoch=1000)
    draws = cell.Draws(3, torch.device("cpu"))
    draws.log = {}
    cap = {}
    model.rpn.register_forward_hook(lambda mod, i, o: cap.__setitem__(
        "rpn", tuple([x.detach() for x in oo] for oo in o)))
    for i in range(D.num_stages(m)):
        model.bbox_head(i).register_forward_hook(
            lambda mod, inp, o, i=i: cap.setdefault("d", {}).__setitem__(i, o[1].detach()))
    batch = pool.train_batch(1)  # the portrait batch
    tb = tr.device_batch(dict(batch))
    out = model.forward_train(tb, draws)
    loss, _ = tr.loss_fn(out, tb, draws, cfg)
    loss.backward()
    b = batch["raw"].shape[0]
    deltas = [cap["d"][i].reshape(b, -1, 4) for i in range(D.num_stages(m) - 1)]
    params = {n: W[n] for n, _ in model.named_parameters()}
    buffers = {n: v for n, v in W.items() if n not in params}
    rl, rg = RT.step(params, buffers, m, batch, draws.log, cap["rpn"], deltas, D.F32)
    assert abs(float(loss.detach()) - rl) <= 1e-5 * abs(rl)
    norms = [float(rg[n].norm()) for n in rg if float(rg[n].norm()) > 0]
    med = sorted(norms)[len(norms) // 2]
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((g - rg[n]).norm()) <= 2e-3 * max(float(rg[n].norm()), med), n
