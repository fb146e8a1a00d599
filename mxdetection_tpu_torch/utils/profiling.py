"""The port's tracer: named spans and counters at its layer boundaries —
port of ``mxdetection_tpu.utils.profiling`` (``jax.profiler`` and named
scopes there).

``annotate(name)`` opens a span around a layer (``Trainer.run_step``'s
``train.*``, ``infer_batch``'s and ``RCNN.forward_test``'s ``infer.*``).
Nothing is recorded unless a ``Recorder`` is installed: without one,
``annotate`` returns one shared no-op context (no ``record_function``, no
allocation, no clock read), and under ``torch.compiler.is_compiling()``
(``tools.export``) it is the no-op always, so an exported graph keeps no
profiler nodes. ``count(name, n)`` adds to a counter of the innermost open
span.

    with Recorder("cuda", events=True) as rec:
        trainer.run_step(batch)
    rec.items()   # {item: {span: {host_ms, self_ms, device_ms, counters}}}

A span keeps its name, its parent, the item id it shares with every span of
the same step or batch (the root's ``item``, else a count of the recorder's
roots), its host start and end (``time.perf_counter_ns``) and, with
``events``, a CUDA event at each end (on the CPU the host clock again). With
``ranges`` each span also opens a ``torch.profiler.record_function`` range,
so that a ``torch.profiler`` trace holds the spans on the kernels' clock. On
the card every root span counts the caching allocator's ``cudaMalloc`` calls
made inside it (``device_allocs``).

``with trace(logdir):`` around a region records the host and, where a card
is present, the device, with a recorder of ranges installed, and writes a
Chrome/Perfetto trace ``<logdir>/trace.json.gz`` that shows the spans above
their kernels.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

_NOOP = contextlib.nullcontext()
_recorder = None  # the installed Recorder


def annotate(name: str, item=None):
    """The span ``name`` of the installed recorder (a context manager), or
    the shared no-op. ``item`` names a root span's step or batch; a nested
    span takes its parent's."""
    rec = _recorder
    if rec is None or torch.compiler.is_compiling():
        return _NOOP
    return _Span(rec, name, item)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    rec = _recorder
    if rec is not None and rec.stack:
        c = rec.stack[-1].counters
        c[name] = c.get(name, 0) + n


def device_allocs(device) -> int:
    """The caching allocator's ``cudaMalloc`` calls on ``device`` so far."""
    return int(torch.cuda.memory_stats_as_nested_dict(device).get("num_device_alloc", 0))


class _Span:
    __slots__ = ("rec", "name", "item", "index", "parent", "t0", "t1", "ev0", "ev1",
                 "counters", "range", "allocs0")

    def __init__(self, rec: "Recorder", name: str, item):
        self.rec, self.name, self.item = rec, name, item
        self.ev0 = self.ev1 = self.range = self.allocs0 = None
        self.counters = {}

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        self.parent = None if parent is None else parent.index
        if self.item is None:
            self.item = parent.item if parent is not None else rec.roots
        if parent is None:
            rec.roots += 1
            if rec.cuda:
                self.allocs0 = device_allocs(rec.device)
        self.index = len(rec.spans)
        rec.spans.append(self)
        rec.stack.append(self)
        if rec.ranges:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        if rec.events:
            self.ev0 = rec.event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        self.t1 = time.perf_counter_ns()
        if rec.events:
            self.ev1 = rec.event()
        if self.allocs0 is not None:  # the span is still the innermost open one
            count("device_allocs", device_allocs(rec.device) - self.allocs0)
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        rec.stack.pop()
        return False


class Recorder:
    """Keeps the spans of the port that open while it is installed (``with
    Recorder(...)``), for one readout when recording has ended.

    ``device``: the device whose work the spans launch; on a CUDA device
    ``events`` records a CUDA event at each end of a span and every root
    span counts ``device_allocs``. ``ranges``: each span is a
    ``record_function`` range of a running ``torch.profiler`` as well."""

    def __init__(self, device=None, *, events: bool = False, ranges: bool = False):
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.events, self.ranges = events, ranges
        self.spans, self.stack, self.roots = [], [], 0
        self._prev = None

    def __enter__(self) -> "Recorder":
        global _recorder
        self._prev, _recorder = _recorder, self
        return self

    def __exit__(self, *exc):
        global _recorder
        _recorder, self._prev = self._prev, None
        return False

    def event(self):
        """A CUDA event recorded now on the current stream; on the CPU the
        host clock (ns)."""
        if not self.cuda:
            return time.perf_counter_ns()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _device_ms(self, s: _Span):
        if s.ev0 is None or s.ev1 is None:
            return None
        if self.cuda:
            return s.ev0.elapsed_time(s.ev1)
        return (s.ev1 - s.ev0) * 1e-6

    def records(self) -> list:
        """Every span in the order they opened, read once recording has
        ended: name, parent (index into this list, None for a root), item,
        host start and end (ns), host ms, host self ms (less its children's
        host ms), device ms (None without events) and counters."""
        if self.cuda and self.events and self.spans:
            torch.cuda.synchronize(self.device)
        child_ns = collections.defaultdict(int)
        for s in self.spans:
            if s.parent is not None:
                child_ns[s.parent] += s.t1 - s.t0
        out = []
        for s in self.spans:
            ns = s.t1 - s.t0
            out.append({"name": s.name, "parent": s.parent, "item": s.item, "t0_ns": s.t0,
                        "t1_ns": s.t1, "host_ms": ns * 1e-6,
                        "self_ms": (ns - child_ns[s.index]) * 1e-6,
                        "device_ms": self._device_ms(s), "counters": dict(s.counters)})
        return out

    def items(self) -> dict:
        """{item: {span name: {host_ms, self_ms, device_ms, counters}}},
        summed where a name repeats in an item, items in order of their
        first span."""
        out = {}
        for r in self.records():
            per = out.setdefault(r["item"], {})
            acc = per.setdefault(r["name"], {"host_ms": 0.0, "self_ms": 0.0, "device_ms": None,
                                             "counters": {}})
            acc["host_ms"] += r["host_ms"]
            acc["self_ms"] += r["self_ms"]
            if r["device_ms"] is not None:
                acc["device_ms"] = (acc["device_ms"] or 0.0) + r["device_ms"]
            for k, v in r["counters"].items():
                acc["counters"][k] = acc["counters"].get(k, 0) + v
        return out


@contextlib.contextmanager
def trace(logdir: str, device=None, filename: str = "trace.json.gz"):
    """Capture a trace of the enclosed region into ``logdir/filename``, the
    port's spans as ranges in it; yields the profiler, whose ``recorder``
    holds the spans."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with Recorder(device, ranges=True) as rec:
            prof.recorder = rec
            yield prof
    prof.export_chrome_trace(os.path.join(logdir, filename))
