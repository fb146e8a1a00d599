"""The port's spans against the device trace: which layer of the port
leaves the card idle, and what each layer costs on the host.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with the port's tracer
(``mxdetection_tpu_torch/utils/profiling.py``) installed: over the window a
recorder with CUDA events (each span's host and host self ms, the
``cudaMalloc`` calls of each step or batch), over the traced slice a
recorder whose spans are ``torch.profiler`` ranges, on the kernels' clock.
It prints the result line of ``run.py --trace 1`` with the metrics below
added (``metrics``), ``breakdown.idle_gaps`` named ``<span>/<op>``, and a
``spans`` table. The benchmark's own runs do not run it: ``cell.py``
installs no recorder yet.

``attribute`` is the charging: each idle gap of the slice (between two
kernels, and before the first and after the last) goes to the innermost
port span that was open when the kernel that ends the gap was launched
(the runtime call that enqueued it, matched by the profiler's correlation
id; without a match, the span open on the host at the gap's middle), or to ``outside``
when no port span was open (the benchmark's own loop). Blocking runtime
calls and kernel launches are counted the same way, by the span open at
the call; each root span's queue time is the wait of its first device
work (kernel, copy or fill) from its enqueueing to its start.
"""

from __future__ import annotations

import bisect
import collections
import os
import sys
import time
from types import SimpleNamespace

PROC_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OUTSIDE = "outside"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
TRAIN_SPANS = ("batch", "forward", "loss", "backward", "optimizer")
INFER_SPANS = ("transform", "backbone", "rpn", "roi_heads", "postprocess")


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host until the card has caught up."""
    return name in SYNCS or (name.startswith("cudaMemcpy") and "Async" not in name)


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cuLaunch")


def is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


class Spans:
    """The port's span ranges of a trace, grouped under their roots, for
    the innermost one open at a host time."""

    def __init__(self, ranges: list, items: list | None):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.roots = []  # [start, end, name, item, [(start, end, name), ...]]
        for s, e, name in ranges:
            if self.roots and s < self.roots[-1][1]:
                self.roots[-1][4].append((s, e, name))
            else:
                self.roots.append([s, e, name, None, []])
        use = items if items is not None and len(items) == len(self.roots) else None
        for i, r in enumerate(self.roots):
            r[3] = use[i] if use is not None else i
        self.starts = [r[0] for r in self.roots]

    def at(self, t: float) -> tuple:
        """(item, innermost span) open at host time ``t``, (None, OUTSIDE)
        outside every root."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t > self.roots[i][1]:
            return None, OUTSIDE
        s0, _, name, item, kids = self.roots[i]
        best = (s0, name)
        for s, e, n in kids:
            if s <= t <= e and s >= best[0]:
                best = (s, n)
        return item, best[1]


def gap_namer(cpu: list):
    """-> name(a, b): the name ``cell.profile_summary`` gives an idle gap
    from ``a`` to ``b`` (us): the innermost host op of ``cpu`` running at
    its middle, else the one the host last left. It asks
    ``profile_summary`` itself, with two empty kernels that bound the gap,
    so that both name a gap alike."""
    from torch.autograd import DeviceType

    from benchmark import cell

    host = [SimpleNamespace(name=e.name, device_type=DeviceType.CPU, time_range=e.time_range,
                            device_time_total=0) for e in cpu]

    def at(t: float):
        return SimpleNamespace(name="", device_type=DeviceType.CUDA, device_time_total=0,
                               time_range=SimpleNamespace(start=t, end=t))

    def name(a: float, b: float) -> str:
        prof = SimpleNamespace(events=lambda: [*host, at(a), at(b)])
        return cell.profile_summary(prof, 0.0)["gaps"][0][0]

    return name


def attribute(events, wall_s: float, names, items: list | None = None) -> dict:
    """Charge a traced slice's idle time, blocking calls and launches to the
    port's spans.

    ``events``: ``torch.profiler``'s ``prof.events()`` (or look-alikes with
    ``name``, ``device_type``, ``id`` and ``time_range`` in us from the
    trace's start); ``wall_s``: the slice's seconds on the host clock;
    ``names``: the port's span names; ``items``: the item id of each root
    span, in order. Returns ``by_span`` rows [item, span, idle_s, syncs,
    launches] (item None for ``outside``), ``queue_s`` rows [item, s],
    ``gaps`` (the ten longest, [``<span>/<op>``, s]) and ``roots``."""
    from torch.autograd import DeviceType

    names = set(names)
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.name not in names),
                  key=lambda e: e.time_range.start)  # a range's copy on the device is no kernel
    cpu_all = [e for e in events if e.device_type == DeviceType.CPU]
    spans = Spans([(e.time_range.start, e.time_range.end, e.name) for e in cpu_all
                   if e.name in names], items)
    cpu = [e for e in cpu_all if e.name not in names]
    runtime = [e for e in cpu if is_runtime(e.name)]
    call = {e.id: e for e in runtime}  # the call that enqueued each device event
    rows = collections.defaultdict(lambda: [0.0, 0, 0])

    def charged_to(k, mid: float) -> tuple:
        r = call.get(k.id) if k is not None else None
        return spans.at(r.time_range.start if r is not None else mid)

    gaps, busy_end = [], 0.0
    for k in kern:
        s, e = k.time_range.start, k.time_range.end
        if s > busy_end:
            gaps.append((busy_end, s, k))
        busy_end = max(busy_end, e)
    wall_us = wall_s * 1e6
    if wall_us > busy_end:
        gaps.append((busy_end, wall_us, None))
    named = []
    for a, b, k in gaps:
        item, span = charged_to(k, (a + b) / 2)
        rows[(item, span)][0] += (b - a) * 1e-6
        named.append((span, a, b))
    for e in runtime:
        if is_sync(e.name) or is_launch(e.name):
            row = rows[spans.at(e.time_range.start)]
            row[1 if is_sync(e.name) else 2] += 1
    queue = []
    by_id = {k.id: k for k in kern}
    for s0, e0, _, item, _ in spans.roots:
        first = min((r for r in runtime if s0 <= r.time_range.start <= e0 and r.id in by_id),
                    key=lambda r: r.time_range.start, default=None)
        if first is not None:
            wait = by_id[first.id].time_range.start - first.time_range.start
            queue.append([item, max(wait, 0.0) * 1e-6])
    top = sorted(named, key=lambda g: g[1] - g[2])[:10]
    op_name = gap_namer(cpu)
    return {"by_span": [[item, span, *v] for (item, span), v in rows.items()],
            "queue_s": queue,
            "gaps": [[f"{span}/{op_name(a, b)}", (b - a) * 1e-6] for span, a, b in top],
            "roots": len(spans.roots)}


# ---------------------------------------------------------------- the metrics


def _mean_over_items(total: float, n: int):
    return total / n if n else None


def host_ms(window: list, span: str):
    """Mean host self ms an item of ``span``, over the window's items."""
    items = {r[0] for r in window}
    return _mean_over_items(sum(r[3] for r in window if r[1] == span), len(items))


def idle_ms(prof: dict, span: str):
    """Mean device idle ms an item charged to ``span`` in the slice."""
    return _mean_over_items(1e3 * sum(r[2] for r in prof["by_span"] if r[1] == span),
                            prof["roots"])


def per_item(prof: dict, col: int):
    """Syncs (col 3) or launches (col 4) an item under the port's roots."""
    return _mean_over_items(sum(r[col] for r in prof["by_span"] if r[1] != OUTSIDE),
                            prof["roots"])


def counter(counters: list, name: str):
    items = {r[0] for r in counters}
    return _mean_over_items(sum(r[3] for r in counters if r[2] == name), len(items))


def queue_ms(prof: dict):
    q = [s for _, s in prof["queue_s"]]
    return 1e3 * sum(q) / len(q) if q else None


def metrics(mode: str, window: list, counters: list, prof: dict | None) -> dict:
    """{metric: (value, unit)} of a cell of ``mode`` from the window's span
    rows [item, span, host_ms, self_ms, device_ms], its counter rows [item,
    span, counter, n] and the slice's ``attribute``."""
    out = {}
    for short in (TRAIN_SPANS if mode == "train" else INFER_SPANS):
        span = f"{mode}.{short}"
        out[f"{short}_host_ms.{mode}"] = (host_ms(window, span), "ms")
        if prof is not None:
            out[f"{short}_idle_ms.{mode}"] = (idle_ms(prof, span), "ms")
    if prof is not None:
        out[f"host_syncs.{mode}"] = (per_item(prof, 3), "calls")
        out[f"launches.{mode}"] = (per_item(prof, 4), "kernels")
        if mode == "infer":
            out["queue_ms.infer"] = (queue_ms(prof), "ms")
    if mode == "train":
        out["device_allocs.train"] = (counter(counters, "device_allocs"), "calls")
    return {k: v for k, v in out.items() if v[0] is not None}


def table(mode: str, window: list, prof: dict | None) -> dict:
    """{span: mean host ms, self ms, device ms, idle ms, syncs, launches an
    item} over every span name and ``outside``."""
    n_win = len({r[0] for r in window}) or 1
    out = {}
    for name in sorted({r[1] for r in window}):
        rows = [r for r in window if r[1] == name]
        dev = [r[4] for r in rows if r[4] is not None]
        out[name] = {"host_ms": sum(r[2] for r in rows) / n_win,
                     "self_ms": sum(r[3] for r in rows) / n_win,
                     "device_ms": sum(dev) / n_win if dev else None}
    if prof is not None and prof["roots"]:
        for item, span, idle, syncs, launches in prof["by_span"]:
            t = out.setdefault(span, {})
            t["idle_ms"] = t.get("idle_ms", 0.0) + 1e3 * idle / prof["roots"]
            t["syncs"] = t.get("syncs", 0.0) + syncs / prof["roots"]
            t["launches"] = t.get("launches", 0.0) + launches / prof["roots"]
    return out


# ---------------------------------------------------------------- the run


class Traced:
    """A run of a cell with the port's recorders installed: over the window
    from ``cell.Marks``'s creation to its readout (or the slice's start),
    over the slice from its start to its stop."""

    def __init__(self):
        from benchmark import cell

        self.cell, self.window, self.prof = cell, None, None
        self.rows, self.counters = [], []
        traced = self

        class Marks(cell.Marks):
            def __init__(self, device):
                super().__init__(device)
                traced.open_window(device)

            def spans(self):
                traced.close_window()
                return super().spans()

        class Slice(cell.Slice):
            def start(self):
                traced.close_window()
                from mxdetection_tpu_torch.utils.profiling import Recorder

                self.recorder = Recorder(self.device, ranges=True).__enter__()
                super().start()

            def stop(self):
                import torch
                from torch.autograd import DeviceType

                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                wall = cell.now() - self.t0
                self.prof.__exit__(None, None, None)
                self.recorder.__exit__(None, None, None)
                recs = self.recorder.records()
                names = {r["name"] for r in recs}
                events = [e for e in self.prof.events()
                          if not (e.device_type == DeviceType.CUDA and e.name in names)]
                self.summary = cell.profile_summary(SimpleNamespace(events=lambda: events), wall)
                traced.prof = attribute(events, wall, names,
                                        [r["item"] for r in recs if r["parent"] is None])
                self.prof = None

        self.classes = {"Marks": Marks, "Slice": Slice}

    def open_window(self, device):
        from mxdetection_tpu_torch.utils.profiling import Recorder

        self.window = Recorder(device, events=True).__enter__()

    def close_window(self):
        if self.window is None:
            return
        self.window.__exit__(None, None, None)
        for item, per in self.window.items().items():
            for name, v in per.items():
                self.rows.append([item, name, v["host_ms"], v["self_ms"], v["device_ms"]])
                self.counters += [[item, name, k, n] for k, n in v["counters"].items()]
        self.window = None

    def run(self, sp: dict, seed: int, seconds: float, device) -> dict:
        """``cell.run`` of ``sp`` with ``--trace 1`` and the recorders ->
        its result line with this module's metrics and tables added."""
        saved = {k: getattr(self.cell, k) for k in self.classes}
        for k, c in self.classes.items():
            setattr(self.cell, k, c)
        try:
            out = self.cell.run(sp, seed, seconds, True, device, PROC_START)
        finally:
            for k, c in saved.items():
                setattr(self.cell, k, c)
            self.close_window()
        if not self.rows or self.prof is None or not self.prof["roots"]:
            raise RuntimeError(
                "the port's recorders saw no root span in the window or the slice: "
                "cell.run no longer builds cell.Marks and cell.Slice, which Traced replaces")
        mode = sp["traffic"]["mode"]
        for name, (v, unit) in metrics(mode, self.rows, self.counters, self.prof).items():
            out["metrics"][name] = {"value": v, "unit": unit}
        out["spans"] = table(mode, self.rows, self.prof)
        if self.prof is not None:
            out["breakdown"]["idle_gaps"] = self.prof["gaps"]
            out["queue_s"] = self.prof["queue_s"]
        out["counters"] = self.counters
        return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="A traced run of a cell with the port's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from benchmark import run  # noqa: F401  (the run's environment: caches, one thread)

    import torch

    from benchmark import cell, spec

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available():
        cell.log("spans.py runs a cell on a CUDA card; this machine has none")
        return 2
    out = Traced().run(spec.cell(args.workload), args.seed, args.seconds, "cuda:0")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
