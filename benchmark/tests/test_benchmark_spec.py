"""Discovery of cells, configurations, traffic and metrics from files, and
the contract's limits on ``BENCHMARK.json``."""

import json
import os
import re
import shutil

import pytest
import torch

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    n = len(BENCH["workloads"])
    # a full check of 24 cells (2 + 14 a cell runs, 60 s beside each, 180 s to
    # compile a cell, 1200 s spare) fits 12 hours at this run length
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


def test_names_units_and_fields():
    names = set()
    for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(x["name"]), x["name"]
        for k in ("why", "layer", "source"):
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] and "\t" not in x[k]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
        names |= set(got)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in BENCH["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    layers = set()
    for x in BENCH["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(x["unit"]) and x["moves"] in e2e
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in x["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[x["moves"]].get("workloads", [w])
        layers.add(x["layer"])
    for w in BENCH["workloads"]:  # setup_s, another end-to-end and a per-layer metric
        sp = spec.cell(w["name"])
        assert "setup_s" in [x["name"] for x in sp["end_to_end"]] and len(sp["end_to_end"]) >= 2
        assert sp["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    sp = spec.cell(cell)
    assert sp["traffic"]["mode"] in ("infer", "train")
    assert set(sp["workload"]["limits"]) and all(v > 0 for v in sp["workload"]["limits"].values())
    for x in sp["end_to_end"] + sp["per_layer"]:
        assert callable(spec.reader(x["name"]))


def test_every_metric_has_a_reader_and_nothing_else_is_there():
    names = {x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")}
    assert names == files


def test_config_files_are_the_programs_configs():
    from benchmark.cell import program_config

    for c in BENCH["configs"]:
        conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        program_config(conf)  # raises where the model section and the program's config differ


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_weight_names_and_shapes_are_the_programs(config):
    from mxdetection_tpu_torch.config import load_config
    from mxdetection_tpu_torch.models.detectors.rcnn import RCNN

    from benchmark.reference.detector import param_specs

    conf = spec.load_json(os.path.join(spec.ROOT, f"benchmark/configs/{config}.json"))
    with torch.device("meta"):
        model = RCNN(load_config(conf["zoo"], conf["overrides"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in param_specs(conf["model"])} == want


def test_a_cell_added_as_files_only(tmp_path):
    """A later PR adds a cell, a traffic mix and a per-layer metric by new
    files and new entries; the harness finds them without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    t = spec.load_json(os.path.join(spec.HERE, "traffic", "infer_b8.json"))
    t["batch"] = 16
    (root / "benchmark" / "traffic" / "infer_b16.json").write_text(json.dumps(t))
    bench["workloads"].append({"name": "faster_r50_fpn.infer_b16", "config": "faster_r50_fpn",
                               "traffic": "infer_b16", "chips": 1, "why": "a later cell"})
    (root / "benchmark" / "workloads" / "faster_r50_fpn.infer_b16.json").write_text(json.dumps(
        {"config": "faster_r50_fpn", "traffic": "infer_b16", "chips": 1, "why": "a later cell",
         "limits": {"rpn_gap": 1.0}}))
    (root / "benchmark" / "metrics" / "batches_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec['items']))\n")
    bench["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "infer_images_per_s",
                               "workloads": ["faster_r50_fpn.infer_b16"]})
    for x in bench["end_to_end"]:
        if "workloads" in x and x["name"].startswith("infer"):
            x["workloads"].append("faster_r50_fpn.infer_b16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sp = spec.cell("faster_r50_fpn.infer_b16", root=str(root))
    assert sp["traffic"]["batch"] == 16
    assert [x["name"] for x in sp["per_layer"]] == ["batches_in_window"]
    assert "infer_images_per_s" in [x["name"] for x in sp["end_to_end"]]
    assert spec.reader("batches_in_window", root=str(root))({"items": [1, 2, 3]}) == 3.0
