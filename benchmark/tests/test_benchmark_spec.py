"""Discovery of cells, configurations, traffic, metrics and detector
families from files, and the contract's limits on ``BENCHMARK.json``."""

import filecmp
import json
import os
import re
import shutil
import time

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
    from benchmark.cell import build_program, program_config

    conf = spec.load_json(os.path.join(spec.ROOT, f"benchmark/configs/{config}.json"))
    model = build_program(program_config(conf), torch.device("meta"), train=True)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = spec.family(conf["family"]).param_specs(conf["model"])
    assert {n: tuple(s) for n, s, _ in specs} == want


FAMILIES = sorted(f[:-3] for f in os.listdir(os.path.join(spec.HERE, "families")) if f.endswith(".py"))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_gives_the_whole_interface(family):
    fam = spec.family(family)  # raises where a name of spec.FAMILY is missing
    for name in spec.FAMILY:
        value = getattr(fam, name)
        assert not callable(value) or value.__doc__, f"{family}.{name} has no docstring"
    for c in BENCH["configs"]:
        conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        if conf["family"] == family:
            laws = fam.weight_laws(conf["model"])
            assert set(laws) <= {kind for _, _, kind in fam.param_specs(conf["model"])}
            assert {law for law, _ in laws.values()} <= {"he_normal", "xavier_uniform", "normal",
                                                         "constant"}


def test_every_config_names_a_family():
    for c in BENCH["configs"]:
        conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert conf["family"] in FAMILIES


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


PROBE = '''"""A family that wraps ``rcnn`` and records each call by its name."""
import os

from benchmark import spec

_RCNN = spec.family("rcnn", os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
CALLS = []


def _recorded(name, f):
    def call(*args, **kwargs):
        CALLS.append(name)
        return f(*args, **kwargs)
    call.__doc__ = f.__doc__
    return call


for _name in spec.FAMILY:
    _value = getattr(_RCNN, _name)
    globals()[_name] = _recorded(_name, _value) if callable(_value) else _value
'''


def checkout_with_a_new_family(root, family: str) -> dict:
    """A copy of the harness with a configuration of ``family`` (Faster
    R-CNN's file with its ``"family"`` changed) and a cell of it under each
    of the Faster cells' traffic and limits, by new files and new entries
    only -> the BENCHMARK.json written there."""
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = spec.load_json(os.path.join(spec.HERE, "configs", "faster_r50_fpn.json"))
    conf.update(name=f"{family}_faster", family=family)
    (root / "benchmark" / "configs" / f"{family}_faster.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": f"{family}_faster", "source": conf["source"],
                             "file": f"benchmark/configs/{family}_faster.json",
                             "reduced": conf["reduced"], "why": "a later detector family"})
    for traffic in ("infer_b32", "train_b8"):
        cell = f"{family}_faster.{traffic}"
        w = spec.load_json(os.path.join(spec.HERE, "workloads", f"faster_r50_fpn.{traffic}.json"))
        w.update(config=f"{family}_faster")
        (root / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps(w))
        bench["workloads"].append({"name": cell, "config": f"{family}_faster", "traffic": traffic,
                                   "chips": 1, "why": "a later detector family"})
        for x in bench["end_to_end"]:
            if f"faster_r50_fpn.{traffic}" in x.get("workloads", []):
                x["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.mark.parametrize("traffic", ["infer_b32", "train_b8"])
def test_a_family_added_as_files_only(tmp_path, traffic):
    """A later PR adds a detector family by a module, a configuration that
    names it, a workload and entries; a run of its cell reads ``correct``
    through the family's functions, and no file of the harness changes."""
    from benchmark import cell
    from benchmark.tests.tiny import tiny_cell

    root = tmp_path / "checkout"
    checkout_with_a_new_family(root, "probe")
    (root / "benchmark" / "families" / "probe.py").write_text(PROBE)
    sp = tiny_cell(f"probe_faster.{traffic}", root=str(root))
    fam = sp["family"]
    assert fam.__file__ == str(root / "benchmark" / "families" / "probe.py")
    out = cell.run(sp, 2 ** 31 + 77, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(sp["workload"]["limits"])
    used = {"param_specs", "weight_laws", "flops_per_item"}
    used |= ({"Keep", "judge_infer"} if traffic == "infer_b32" else
             {"Follow", "whole_batch", "train_step", "warmup_multistep", "sgd_step"})
    assert used <= set(fam.CALLS), fam.CALLS
    cmp = filecmp.dircmp(os.path.join(spec.ROOT, "benchmark"), str(root / "benchmark"),
                         ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + d.left_only + [f for sub in d.subdirs.values() for f in changed(sub)]
    assert changed(cmp) == []


def test_an_unknown_family_fails_naming_its_file(tmp_path):
    root = tmp_path / "checkout"
    checkout_with_a_new_family(root, "nowhere")
    with pytest.raises(FileNotFoundError, match=re.escape(
            os.path.join(str(root), "benchmark", "families", "nowhere.py"))):
        spec.cell("nowhere_faster.train_b8", root=str(root))
