"""A whole run of each cell at a tiny size on the CPU (the look for a card
skipped), sound and with the timed path broken underneath: ``correct``
holds for the sound program and comes out false for each fault the cell
can have, also where a training fault starts only in the measured window,
after the set-up's followed steps. And the control, the reference in float8 in the program's place,
reads at least three times the program's number on one of the cell's
numbers (its chip readings at the cell's own size are in PERF.md)."""

import time

import pytest
import torch

from benchmark import cell, check, spec
from benchmark.control import control_entry
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 77
INFER = ["faster_r50_fpn.infer_b32", "cascade_r101_dcn.infer_b8"]
TRAIN = ["faster_r50_fpn.train_b8", "cascade_r101_dcn.train_b8"]


def run(name, **faults):
    return cell.run(tiny_cell(name), SEED, 0.5, False, "cpu", time.perf_counter(), **faults)


def half_batch_entry():
    """Half of the batch left out: the detector runs on the first half and
    its outputs stand in for the rest."""
    from mxdetection_tpu_torch.tools.common import infer_batch

    def entry(model, cfg, raw, hw, dtype):
        h = raw.shape[0] // 2
        dets, out = infer_batch(model, cfg, raw[:h], hw[:h], dtype)
        rep = lambda t: torch.cat([t, t][: 2])[: raw.shape[0]]  # noqa: E731
        return ({k: rep(v) for k, v in dets.items()},
                {k: (rep(v) if isinstance(v, torch.Tensor) and v.shape[:1] == (h,) else v)
                 for k, v in out.items()})
    return entry


def altered_entry():
    """An answer altered where it is produced: the first valid detection's
    box moves by one pixel."""
    from mxdetection_tpu_torch.tools.common import infer_batch

    def entry(model, cfg, raw, hw, dtype):
        dets, out = infer_batch(model, cfg, raw, hw, dtype)
        v = dets["valid"].flatten().nonzero()[:1]
        boxes = dets["boxes"].reshape(-1, 4).clone()
        boxes[v] += 1.0
        return {**dets, "boxes": boxes.reshape(dets["boxes"].shape)}, out
    return entry


def stage_deltas_entry():
    """A fault in a cascade's first-stage box regression: its deltas move
    before the next stage decodes its rois from them (the hook runs ahead
    of the benchmark's, which reads the deltas the program used)."""
    from mxdetection_tpu_torch.tools.common import infer_batch

    hooked = []

    def entry(model, cfg, raw, hw, dtype):
        if not hooked:
            hooked.append(model.bbox_head(0).register_forward_hook(
                lambda mod, inp, out: (out[0], out[1] + 1.0), prepend=True))
        return infer_batch(model, cfg, raw, hw, dtype)
    return entry


def dropped_entry():
    """An answer left out where it is produced: the first valid detection
    is marked invalid."""
    from mxdetection_tpu_torch.tools.common import infer_batch

    def entry(model, cfg, raw, hw, dtype):
        dets, out = infer_batch(model, cfg, raw, hw, dtype)
        valid = dets["valid"].reshape(-1).clone()
        valid[valid.nonzero()[:1]] = False
        return {**dets, "valid": valid.reshape(dets["valid"].shape)}, out
    return entry


@pytest.mark.parametrize("name", INFER + TRAIN)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", INFER)
@pytest.mark.parametrize("fault", [half_batch_entry, altered_entry, dropped_entry])
def test_inference_faults_are_not_correct(name, fault):
    out = run(name, entry=fault())
    assert not out["correct"], out["checks"]


def test_cascade_stage_regression_fault_is_not_correct():
    out = run("cascade_r101_dcn.infer_b8", entry=stage_deltas_entry())
    assert not out["correct"], out["checks"]
    assert out["checks"]["stage_box_gap"]["value"] > out["checks"]["stage_box_gap"]["limit"]


def unchanged_state(trainer, batch, draws):
    """A step that returns its state unchanged: the update is undone."""
    params = [p.detach().clone() for p in trainer.params]
    trace = [m.clone() for m in trainer.optimizer.trace]
    count = trainer.optimizer.count
    metrics = trainer.run_step(batch, draws)
    with torch.no_grad():
        for p, q in zip(trainer.params, params):
            p.copy_(q)
        for m, q in zip(trainer.optimizer.trace, trace):
            m.copy_(q)
    trainer.optimizer.count = count
    return metrics


def half_batch_step(trainer, batch, draws):
    """Half of the batch left out, the mean taken over the rest."""
    h = batch["raw"].shape[0] // 2
    return trainer.run_step({k: (v[:h] if isinstance(v, torch.Tensor) else v)
                             for k, v in batch.items()}, draws)


def from_the_window(fault):
    """``fault`` from the window's first step on: the set-up's followed
    steps run sound, as a program that changes its path after warm-up."""
    calls = [0]

    def step_fn(trainer, batch, draws):
        calls[0] += 1
        if calls[0] <= cell.FOLLOWED_STEPS:
            return trainer.run_step(batch, draws)
        return fault(trainer, batch, draws)
    return step_fn


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch_step])
@pytest.mark.parametrize("late", [False, True])
def test_training_faults_are_not_correct(name, fault, late):
    extra = {}
    out = run(name, step_fn=from_the_window(fault) if late else fault, extra=extra)
    assert not out["correct"], out["checks"]
    if late:  # the set-up's following reads sound; the window's catches the fault
        n = extra["numbers"]
        assert all(n[f"{k}.setup"] <= out["checks"][k]["limit"] for k in out["checks"]), n


@pytest.mark.parametrize("name", INFER)
def test_inference_control_reads_three_times_the_program(name):
    sp = tiny_cell(name)
    sp["traffic"].update(warmup_batches=0, min_batches=sp["traffic"]["check_batches"])
    prog = cell.run(sp, SEED, 0.0, False, "cpu", time.perf_counter())["checks"]
    ctrl = cell.run(sp, SEED, 0.0, False, "cpu", time.perf_counter(),
                    entry=control_entry(sp["family"]))["checks"]
    assert any(ctrl[k]["value"] >= 3 * prog[k]["value"] for k in prog), (prog, ctrl)


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_reads_three_times_the_program(name):
    extra = {}
    prog = cell.run(tiny_cell(name), SEED, 0.0, False, "cpu", time.perf_counter(),
                    extra=extra)["checks"]
    sp = tiny_cell(name)
    ctrl = check.judge_followings(sp["family"], sp["config"]["model"], extra, sp["family"].CONTROL,
                                  steps_per_epoch=cell.STEPS_PER_EPOCH)
    assert any(ctrl[k] >= 3 * prog[k]["value"] for k in prog), (prog, ctrl)


@pytest.mark.parametrize("shift, keeps_both, holds", [
    (33.33, True, True),    # IoU 0.50002: over the threshold by less than rounding, either way holds
    (33.33, False, True),
    (20.0, True, False),    # IoU 0.667: both kept is no greedy NMS
    (20.0, False, True),
    (43.0, False, False),   # IoU 0.397: the second box left out unsuppressed
    (43.0, True, True),
])
def test_greedy_sources_holds_nms_to_its_guarantees(shift, keeps_both, holds):
    m = tiny_cell("faster_r50_fpn.infer_b32")["config"]["model"]
    k = m["bbox_head"]["num_classes"]
    rois = torch.tensor([[[10.0, 10.0, 110.0, 110.0], [10.0 + shift, 10.0, 110.0 + shift, 110.0]]])
    probs = torch.zeros(1, 2, k + 1)
    probs[0, :, 3] = torch.tensor([0.9, 0.8])
    probs[0, :, 0] = 1.0 - probs[0, :, 3]
    deltas = torch.zeros(1, 2, 4 * (k + 1))
    info = torch.tensor([[200.0, 200.0, 1.0]])
    n = 2 if keeps_both else 1
    got = {"boxes": rois[0, :n], "scores": probs[0, :n, 3], "labels": torch.full((n,), 2),
           "valid": torch.ones(n, dtype=torch.bool)}
    src, why = spec.family("rcnn").greedy_sources(rois, torch.ones(1, 2, dtype=torch.bool), probs,
                                                  deltas, info, got, m)
    assert (why is None) == holds, why
    if holds:
        assert src.tolist() == [2, k + 2][:n]
