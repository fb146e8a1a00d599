"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, ``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``,
``benchmark/workloads/<cell>.json`` (the cell's correctness limits) and one
reader a metric, ``benchmark/metrics/<metric>.py``. A later cell,
configuration, traffic mix or metric is a new file and a new entry, never
an edit of the harness."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` reads: its entry, configuration,
    traffic, limits and the metrics it reports (end-to-end with
    ``--trace 0``, per-layer with ``--trace 1``)."""
    bench = benchmark(root) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = entries[name]
    here = os.path.join(root, "benchmark")
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    out = {
        "entry": w,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        "workload": load_json(os.path.join(here, "workloads", f"{name}.json")),
    }
    for key in ("config", "traffic", "chips"):
        if out["workload"][key] != w[key]:
            raise ValueError(f"{name}: benchmark/workloads/{name}.json says {key} "
                             f"{out['workload'][key]!r}, BENCHMARK.json {w[key]!r}")
    out["end_to_end"] = [x for x in bench["end_to_end"] if name in x.get("workloads", [name])]
    out["per_layer"] = [x for x in bench["per_layer"] if name in x.get("workloads", [name])]
    return out


def reader(metric: str, root: str = ROOT):
    """The ``read(records)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
