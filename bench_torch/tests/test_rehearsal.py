"""Every cell of BENCHMARK.json end to end on the CPU at the rehearsal's
tiny sizes, untraced and traced: each cell's files, each metric's reader
and the last line's keys resolve by name, and the sound program comes out
correct. A new cell, configuration or metric file is picked up without an
edit to any file there."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_torch import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def rehearse(cell, trace, seed=4000000007, root=ROOT, seconds=1.5):
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_torch", "run.py"), "--workload", cell, "--seed",
                           str(seed), "--seconds", str(seconds), "--trace", str(trace), "--rehearse"],
                          capture_output=True, text=True, timeout=600, cwd=root,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses(cell, trace):
    result, err = rehearse(cell, trace)
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert err.strip().splitlines()[-1] == "check correct: True"
    if trace:
        expected = {m["name"] for m in run.cell_metrics(BENCH, cell, "per_layer")}
        # the CPU has no device trace: only the metrics of the work itself read
        assert set(result["metrics"]) <= expected and any(k.startswith("mfu") for k in result["metrics"])
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in run.cell_metrics(BENCH, cell, "end_to_end")}


def test_a_new_cell_and_metric_are_picked_up(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_torch"), tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve_small_ngp_xor", "config": "ngp_xor", "traffic": "serve_small",
                               "chips": 1, "why": "a cell added as data"})
    bench["per_layer"].append({"name": "points.serve", "unit": "points/frame", "better": "higher",
                               "source": "program_counter", "layer": "render engine", "moves": "frame_ms",
                               "workloads": ["serve_small_ngp_xor"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with open(os.path.join(ROOT, "bench_torch", "workloads", "serve_exact_ngp_quad.json")) as f:
        workload = json.load(f)
    workload.update(config="ngp_xor")
    (tmp_path / "bench_torch" / "workloads" / "serve_small_ngp_xor.json").write_text(json.dumps(workload))
    (tmp_path / "bench_torch" / "metrics" / "points.serve.py").write_text(
        "def read(r):\n    return r['work']['points'] / r['units']\n")
    result, _ = rehearse("serve_small_ngp_xor", 1, root=str(tmp_path))
    assert result["correct"] is True and result["metrics"]["points.serve"]["value"] > 0
