"""BENCHMARK.json agrees with the files the harness finds by name: each
cell's workload file (its configuration, chips, why), each configuration's
file, and each per-layer metric's reader; a metric's declarations live in
BENCHMARK.json alone."""

import json
import os

import pytest

from bench_torch import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    with open(os.path.join(run.HERE, "workloads", cell["name"] + ".json")) as f:
        w = json.load(f)
    assert (w["config"], w["chips"], w["why"]) == (cell["config"], cell["chips"], cell["why"])
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(config):
    with open(os.path.join(run.ROOT, config["file"])) as f:
        c = json.load(f)
    assert (c["name"], c["source"], c["reduced"]) == (config["name"], config["source"], config["reduced"])
    assert config["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    module = run.reader(metric["name"])
    assert callable(module.read)
    assert not {"LAYER", "UNIT", "MOVES", "WORKLOADS"} & set(vars(module))
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves.get("workloads", metric["workloads"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in (w["name"] for w in BENCH["workloads"]):
        e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, cell, "per_layer")
