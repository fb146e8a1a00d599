"""``benchmark/spans.py``: the charging of a traced slice's idle gaps,
blocking calls and launches to the port's spans, on a synthetic event list,
and a traced run of each tiny cell with the port's recorders installed, on
the CPU."""

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import spans
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 91


def ev(name, start, end, device=DeviceType.CPU, corr=0):
    return SimpleNamespace(name=name, device_type=device, id=corr,
                           time_range=SimpleNamespace(start=start, end=end))


def kernel(name, start, end, corr):
    return ev(name, start, end, DeviceType.CUDA, corr)


# a step's root with two spans, three kernels; the third is launched after
# the root has closed (outside any span), the gap it ends is outside's
EVENTS = [
    ev("train.step", 0, 260), ev("train.forward", 10, 100), ev("train.loss", 120, 250),
    ev("cudaLaunchKernel", 20, 25, corr=1), ev("aten::to", 50, 58),
    ev("cudaMemcpyAsync", 50, 55, corr=2),
    ev("cudaLaunchKernel", 130, 135, corr=3), ev("cudaStreamSynchronize", 220, 240),
    ev("cudaMemcpy", 270, 280), ev("cudaLaunchKernel", 300, 305, corr=4),
    kernel("k1", 30, 60, 1), kernel("k2", 140, 200, 3), kernel("k3", 310, 330, 4),
]
NAMES = {"train.step", "train.forward", "train.loss"}


def test_idle_syncs_launches_and_gaps_charged_to_spans():
    got = spans.attribute(EVENTS, 400e-6, NAMES, items=[12])
    rows = {(r[0], r[1]): r[2:] for r in got["by_span"]}
    us = 1e-6
    # head gap 0-30 (k1 launched in forward), 60-140 (k2 launched in loss),
    # 200-310 (k3 launched outside), tail 330-400 (nothing open at 365)
    assert rows[(12, "train.forward")] == pytest.approx([30 * us, 0, 1])
    assert rows[(12, "train.loss")] == pytest.approx([80 * us, 1, 1])
    assert rows[(None, "outside")] == pytest.approx([180 * us, 1, 1])
    assert sum(r[2] for r in got["by_span"]) == pytest.approx((400 - 110) * us)
    assert got["roots"] == 1 and got["queue_s"] == [[12, pytest.approx(10 * us)]]
    assert got["gaps"] == [["outside/after cudaStreamSynchronize", pytest.approx(110 * us)],
                           ["train.loss/after aten::to", pytest.approx(80 * us)],
                           ["outside/after cudaLaunchKernel", pytest.approx(70 * us)],
                           ["train.forward/host", pytest.approx(30 * us)]]
    assert spans.idle_ms(got, "train.loss") == pytest.approx(0.08)
    assert spans.per_item(got, 3) == 1 and spans.per_item(got, 4) == 2


def test_a_kernel_without_its_launch_is_charged_by_the_gaps_middle():
    events = [e for e in EVENTS if not (e.name == "cudaLaunchKernel" and e.id == 3)]
    rows = {(r[0], r[1]): r[2] for r in spans.attribute(events, 400e-6, NAMES)["by_span"]}
    # 60-140: the middle, 100, lies in forward (10-100) and the root
    assert rows[(0, "train.forward")] == pytest.approx(110e-6)
    assert rows[(0, "train.loss")] == 0  # its sync alone


@pytest.mark.parametrize("name,mode", [("faster_r50_fpn.infer_b32", "infer"),
                                       ("faster_r50_fpn.train_b8", "train")])
def test_traced_run_reports_the_span_metrics(name, mode):
    out = spans.Traced().run(tiny_cell(name), SEED, 0.3, "cpu")
    m = out["metrics"]
    parts = spans.TRAIN_SPANS if mode == "train" else spans.INFER_SPANS
    for short in parts:
        assert m[f"{short}_host_ms.{mode}"]["value"] > 0
        assert f"{short}_idle_ms.{mode}" in m
    assert m[f"host_ms.{mode}"]["value"] >= sum(m[f"{s}_host_ms.{mode}"]["value"] for s in parts)
    assert all(g[0].split("/")[0] in out["spans"] for g in out["breakdown"]["idle_gaps"])
    assert out["correct"] and out["spans"][f"{mode}.{'step' if mode == 'train' else 'batch'}"]
    assert time.perf_counter() > spans.PROC_START


def test_a_copy_is_charged_by_its_enqueueing_call_and_starts_the_queue():
    events = [ev("infer.batch", 0, 100), ev("infer.transform", 0, 40),
              ev("cudaMemcpyAsync", 10, 15, corr=5), kernel("Memcpy HtoD", 50, 60, 5)]
    got = spans.attribute(events, 60e-6, {"infer.batch", "infer.transform"})
    assert got["by_span"] == [[0, "infer.transform", pytest.approx(50e-6), 0, 0]]
    assert got["queue_s"] == [[0, pytest.approx(40e-6)]]


def test_a_run_whose_recorders_saw_nothing_fails(monkeypatch):
    """Where ``cell.run`` stops building ``cell.Marks`` and ``cell.Slice``,
    ``Traced``'s recorders are never installed: the run fails rather than
    print a line without the span metrics."""
    from benchmark import cell

    monkeypatch.setattr(cell, "run", lambda *a, **kw: {"metrics": {}, "breakdown": {}})
    with pytest.raises(RuntimeError, match="no root span"):
        spans.Traced().run(tiny_cell("faster_r50_fpn.train_b8"), SEED, 0.3, "cpu")
