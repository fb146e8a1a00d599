"""A cell cut to a size the CPU runs in seconds, for the CPU tests: the same
files, with the canvas, the proposal and sample counts and the pool shrunk
(the widths stay as published). A cell whose files are kept under
``benchmark/workloads`` without an entry in ``BENCHMARK.json`` (Cascade
inference and Faster training, out of the benchmark for their host-paced
spreads) is tested with the entry its workload file gives and the metrics
that the benchmark's cells of its mode report."""

from __future__ import annotations

import copy
import dataclasses
import json
import os

from benchmark import spec

TINY = {"data.pad_h": 128, "data.pad_w": 160, "data.scale": 120, "data.max_size": 160,
        "rpn.pre_nms_top_n_test": 150, "rpn.post_nms_top_n_test": 40,
        "rpn.pre_nms_top_n_train": 150, "rpn.post_nms_top_n_train": 60,
        "bbox_head.num_samples": 32, "data.max_gt": 8}


def traffic_mode(root: str, traffic: str) -> str:
    return spec.load_json(os.path.join(root, "benchmark", "traffic", f"{traffic}.json"))["mode"]


def tiny_cell(name: str, pool: int = 8, batch: int = 2, dtype: str | None = None,
              root: str = spec.ROOT) -> dict:
    from mxdetection_tpu_torch.config import load_config

    bench = spec.benchmark(root)
    if name not in [w["name"] for w in bench["workloads"]]:
        w = spec.load_json(os.path.join(root, "benchmark", "workloads", f"{name}.json"))
        mode = traffic_mode(root, w["traffic"])
        same = {x["name"] for x in bench["workloads"] if traffic_mode(root, x["traffic"]) == mode}
        for x in bench["end_to_end"] + bench["per_layer"]:
            if same & set(x.get("workloads", ())):
                x["workloads"].append(name)
        bench["workloads"].append({"name": name, **{k: w[k] for k in ("config", "traffic", "chips", "why")}})
    full = spec.cell(name, root, bench=bench)
    sp = copy.deepcopy(full, {id(full["family"]): full["family"]})
    conf = sp["config"]
    conf["overrides"] = {**conf["overrides"], **TINY}
    if dtype is not None:
        conf["overrides"]["backbone.dtype"] = dtype
    cfg = load_config(conf["zoo"], conf["overrides"])
    conf["model"] = json.loads(json.dumps(dataclasses.asdict(cfg)))
    t = sp["traffic"]
    t.update(pool=pool, batch=batch, canvas=[72, 96], sizes=[[54, 72, 3], [72, 54, 1]],
             warmup_batches=2, check_batches=1, check_images=2, trace_items=2)
    if t.get("follow_window_steps"):
        t["follow_window_steps"] = [1, 2]
    if t.get("gt"):
        t["gt"] = {**t["gt"], "max": 6, "mean": 3.0, "max_gt": 8}
    return sp
