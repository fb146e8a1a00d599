"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, ``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``,
``benchmark/workloads/<cell>.json`` (the cell's correctness limits), one
reader a metric, ``benchmark/metrics/<metric>.py``, and one module a
detector family, ``benchmark/families/<family>.py``, named by the
configuration file's top-level ``"family"`` key. The family module holds
everything of a run that depends on the detector (its weights, the hooks
that keep what the reference follows, the f32 reference, the FLOP count and
the kernels' bounds: ``FAMILY``); the rest of the harness is the same for
every detector. A later cell, configuration, traffic mix, metric or
detector family is a new file and a new entry, never an edit of the
harness."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# What a family module gives (each documented in ``benchmark/families/rcnn.py``):
FAMILY = (
    "param_specs", "weight_laws", "calibration_forward",  # the seeded weights
    "F32", "CONTROL", "warmup_multistep", "sgd_step",     # the reference's precisions and optimizer
    "Follow", "whole_batch", "train_step",                # following a training step
    "DETECTIONS", "Keep", "detect", "judge_infer",        # judging an inference batch
    "infer_marks", "infer_facts", "infer_bounds",         # the traced inference slice
    "train_facts", "train_bounds",                        # the traced training slice
    "model_flops", "flops_per_item",                      # the model FLOPs of ``*_mfu``
)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` reads: its entry, configuration,
    detector family (the module), traffic, limits and the metrics it
    reports (end-to-end with ``--trace 0``, per-layer with ``--trace 1``)."""
    bench = benchmark(root) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = entries[name]
    here = os.path.join(root, "benchmark")
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(os.path.join(root, conf["file"]))
    if "family" not in config:
        raise KeyError(f"{conf['file']} names no detector family (its top-level \"family\" key)")
    out = {
        "entry": w,
        "config": config,
        "family": family(config["family"], root),
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


def family(name: str, root: str = ROOT):
    """The module ``benchmark/families/<name>.py``, loaded by path; it has
    to give every name of ``FAMILY``."""
    path = os.path.join(root, "benchmark", "families", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no detector family {name!r}: looked for {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in FAMILY if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"{path} does not give {missing}")
    return mod
