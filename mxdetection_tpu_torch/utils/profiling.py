"""Profiling hooks on ``torch.profiler`` — port of
``mxdetection_tpu.utils.profiling`` (``jax.profiler`` and named scopes there).

``with trace(logdir):`` around a region records the host and, where a card
is present, the device, and writes a Chrome/Perfetto trace
``<logdir>/trace.json.gz``; ``annotate(name)`` labels a span of it (as a
context manager or a decorator).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed region into ``logdir``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json.gz"))


def annotate(name: str):
    """A named span on the trace's timeline."""
    return torch.profiler.record_function(name)
