"""The port's tracer, ``utils/profiling.py``, on the CPU: a recorder's
spans (nesting, parents, item ids, self time, counters), the no-op path
without one, its ranges in a ``torch.profiler`` trace, the spans of
``Trainer.run_step`` and ``infer_batch`` on a tiny detector, and an export
with a recorder installed. One tiny Faster R-CNN (``faster``) serves the
file's tests.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.tools import export as texport
from mxdetection_tpu_torch.tools.common import infer_batch
from mxdetection_tpu_torch.train.trainer import Trainer
from mxdetection_tpu_torch.utils import profiling
from mxdetection_tpu_torch.utils.profiling import Recorder, annotate, count

TINY = {"data.pad_h": 64, "data.pad_w": 64, "data.scale": 48, "data.max_size": 64,
        "data.max_gt": 4, "bbox_head.num_samples": 16, "bbox_head.num_classes": 3,
        "rpn.pre_nms_top_n_train": 64, "rpn.post_nms_top_n_train": 32,
        "rpn.pre_nms_top_n_test": 64, "rpn.post_nms_top_n_test": 32,
        "test.pre_nms_per_class": 64, "test.max_per_image": 10, "backbone.dtype": "float32"}
TRAIN_SPANS = ["train.step", "train.batch", "train.forward", "train.loss", "train.backward",
               "train.optimizer"]
INFER_SPANS = ["infer.batch", "infer.transform", "infer.forward", "infer.backbone", "infer.rpn",
               "infer.roi_heads", "infer.postprocess"]


def tiny(name="faster_rcnn_r50_fpn_1x", train=False):
    cfg = load_config(name, TINY)
    return cfg, build_detector(cfg, device="cpu", seed=0, train=train)


@pytest.fixture(scope="module")
def faster():
    """(cfg, model): a tiny f32 Faster R-CNN built for training; the tests
    that infer with it put it in eval mode."""
    return tiny(train=True)


def images(b=2):
    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (b, 48, 60, 3), generator=gen, dtype=torch.uint8)
    return raw, torch.tensor([[48.0, 60.0]] * b)


def sleep_ms(ms):
    t = time.perf_counter() + ms * 1e-3
    while time.perf_counter() < t:
        pass


def test_spans_nest_share_items_and_keep_self_time():
    with Recorder("cpu", events=True) as rec:
        with annotate("a", item=7):
            sleep_ms(2)
            with annotate("b"):
                sleep_ms(3)
                count("x", 2)
            with annotate("c"):
                with annotate("d"):
                    count("x")
                    sleep_ms(1)
                count("x", 4)
        with annotate("a"):
            pass
    assert profiling._recorder is None
    r = rec.records()
    assert [s["name"] for s in r] == ["a", "b", "c", "d", "a"]
    assert [s["parent"] for s in r] == [None, 0, 0, 2, None]
    assert [s["item"] for s in r] == [7, 7, 7, 7, 1]
    assert [s["counters"] for s in r] == [{}, {"x": 2}, {"x": 4}, {"x": 1}, {}]
    a, b, c, d = r[:4]
    assert a["self_ms"] == pytest.approx(a["host_ms"] - b["host_ms"] - c["host_ms"], abs=1e-9)
    assert c["self_ms"] == pytest.approx(c["host_ms"] - d["host_ms"], abs=1e-9)
    assert a["self_ms"] >= 2 and b["self_ms"] >= 3 and d["host_ms"] >= 1
    for s in r:  # the CPU's events are the host clock
        assert s["host_ms"] <= s["device_ms"] <= s["host_ms"] + 1
    items = rec.items()
    assert list(items) == [7, 1]
    assert items[7]["c"]["counters"] == {"x": 4}
    assert items[7]["a"]["host_ms"] == pytest.approx(a["host_ms"])


def test_no_recorder_records_nothing_and_opens_no_range(monkeypatch):
    opened = []

    class Counted(torch.autograd.profiler.record_function):
        def __init__(self, name, *a):
            opened.append(name)
            super().__init__(name, *a)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    first = annotate("train.step", 0)
    for _ in range(3):
        with annotate("x") as got:
            count("n")
            assert got is None and annotate("y", 5) is first
    with Recorder("cpu") as rec:
        with annotate("a"):
            with annotate("b"):
                pass
    assert opened == [] and len(rec.records()) == 2
    with Recorder("cpu", ranges=True):
        with annotate("a"):
            pass
    assert opened == ["a"]


def test_ranges_are_in_a_cpu_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Recorder("cpu", ranges=True):
            with annotate("outer"):
                with annotate("inner"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
    ev = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    assert set(ev) == {"outer", "inner"}
    o, i = ev["outer"].time_range, ev["inner"].time_range
    assert o.start <= i.start <= i.end <= o.end
    assert any(e.name == "aten::mm" and i.start <= e.time_range.start <= i.end
               for e in prof.events())


def test_train_step_and_infer_batch_spans(faster):
    cfg, model = faster
    model.train()
    trainer = Trainer(cfg, model, device="cpu")
    raw, hw = images()
    batch = {"raw": raw, "hw": hw, "flip": torch.tensor([False, True]),
             "gt_boxes": torch.tensor([[[4.0, 4.0, 30.0, 40.0]] * 4] * 2),
             "gt_labels": torch.ones((2, 4), dtype=torch.int32),
             "gt_valid": torch.tensor([[True, False, False, False]] * 2)}
    with Recorder("cpu", events=True) as rec:
        trainer.run_step(batch)
        trainer.run_step(batch)
    r = rec.records()
    assert [s["name"] for s in r] == TRAIN_SPANS * 2
    assert [s["item"] for s in r] == [0] * 6 + [1] * 6
    assert [s["parent"] for s in r[:6]] == [None] + [0] * 5
    root = r[0]
    assert sum(s["host_ms"] for s in r[1:6]) <= root["host_ms"]
    assert "device_allocs" not in root["counters"]  # counted on the card alone

    model.eval()
    with Recorder("cpu") as rec:
        infer_batch(model, cfg, raw, hw, torch.float32)
        infer_batch(model, cfg, raw, hw, torch.float32)
    r = rec.records()
    assert [s["name"] for s in r] == INFER_SPANS * 2
    assert [s["item"] for s in r] == [0] * 7 + [1] * 7
    assert [s["parent"] for s in r[:7]] == [None, 0, 0, 2, 2, 2, 0]

    mcfg, mask = tiny("mask_rcnn_r50_fpn_1x")
    with Recorder("cpu") as rec:
        dets, _ = infer_batch(mask, mcfg, raw, hw, torch.float32)
    assert "masks" in dets
    assert [s["name"] for s in rec.records()] == INFER_SPANS + ["infer.masks"]


def test_export_with_a_recorder_keeps_no_profiler_nodes(faster):
    """``tools.export`` traces through the spans with a recorder installed:
    the recorder sees nothing, the graph holds no profiler node, and the
    artifact's detections are the eager ones."""
    cfg, model = faster
    model.eval()
    raw, hw = images(1)
    eager = texport.ServingModule(model, cfg)(raw, hw)
    with Recorder("cpu", events=True, ranges=True) as rec:
        program = texport.export_serving(model, cfg, 1, (48, 60))
    assert rec.records() == []
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert any("roi_align" in t for t in targets)
    with torch.no_grad():
        served = program.module()(raw, hw)
    for got, ref in zip(served, eager, strict=True):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
