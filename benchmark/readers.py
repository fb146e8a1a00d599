"""What the metric readers share. A reader, ``benchmark/metrics/<metric>.py``,
defines ``read(records) -> float | None`` over a run's records (see
``cell.py``): ``mode``, ``batch``, ``setup_s``, ``window_s``, ``items``
(each batch's or step's ``images``, ``host_s`` and, for inference,
``latency_s``), ``flops_per_item`` and, in a traced run, ``stages`` ({span:
[ms an item]}) and ``profile`` (``busy_s``, ``window_s``, seconds by
``kernels`` and by host ``ops``, ``gaps`` and the kernels' least seconds,
``bounds``). A reader that finds nothing to read returns None."""

from __future__ import annotations

import statistics

from .flops import BF16_TC_FLOPS


def stage_ms(rec: dict, mode: str, span: str):
    if rec.get("mode") != mode or span not in rec.get("stages", {}):
        return None
    return statistics.fmean(rec["stages"][span])


def host_ms(rec: dict, mode: str):
    if rec.get("mode") != mode or not rec["items"] or "stages" not in rec:
        return None
    return 1e3 * statistics.fmean(i["host_s"] for i in rec["items"])


def images_per_s(rec: dict, mode: str):
    if rec.get("mode") != mode or not rec["items"]:
        return None
    return sum(i["images"] for i in rec["items"]) / rec["window_s"]


def mfu(rec: dict, mode: str):
    """Model FLOPs of the window's batches or steps over its seconds, as a
    share (%) of the bf16 tensor-core peak."""
    if rec.get("mode") != mode or not rec["items"]:
        return None
    return 100.0 * rec["flops_per_item"] * len(rec["items"]) / rec["window_s"] / BF16_TC_FLOPS


def device_idle(rec: dict, mode: str):
    p = rec.get("profile")
    if rec.get("mode") != mode or not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def device_seconds(p: dict, ops=(), kernels=()) -> float:
    """The traced slice's device seconds of a piece of work: under the
    registered operators ``ops`` where the trace has them, else in the
    kernels whose names hold one of ``kernels``."""
    t = sum(s for name, s in p["ops"].items() if name in ops)
    if t > 0:
        return t
    return sum(s for name, s in p["kernels"].items() if any(k in name for k in kernels))


def roofline(rec: dict, mode: str, bound: str, ops=(), kernels=()):
    """The kernels' least seconds over their device seconds in the traced
    slice, as a share (%)."""
    p = rec.get("profile")
    if rec.get("mode") != mode or not p:
        return None
    t, b = device_seconds(p, ops, kernels), p["bounds"].get(bound, 0.0)
    if t <= 0 or b <= 0:
        return None
    return 100.0 * b / t
