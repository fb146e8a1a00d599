"""On the card only (``-m card``): each cell's command as the check runs it,
at a short window, untraced and traced, prints a result line that meets the
contract's form and reads ``correct``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2 ** 31 + 4242 + trace), "--seconds", "5", "--trace", str(trace)],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    sp = spec.cell(cell)
    want = {x["name"] for x in (sp["per_layer"] if trace else sp["end_to_end"])}
    assert set(out["metrics"]) <= want and (trace or set(out["metrics"]) == want)
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for name, m in out["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name
    assert list(out)[-1] == "checks"
