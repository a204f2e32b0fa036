"""Every cell of BENCHMARK.json end to end on the CPU at the rehearsal's
tiny sizes, untraced and traced: each cell's files, each metric's reader
and the last line's keys resolve by name, and the sound program comes out
correct.

The contract for what comes later, held here: a new cell brings its entries
in BENCHMARK.json and new files only, and edits no file already there. A
new configuration brings its file under ``configs/`` (its ``run`` tree,
and a ``rehearse`` block of dotted keys with its tiny sizes) and its plain
reference; new traffic code brings ``drivers/<driver>.py`` (``DRIVER(ctx)``:
``setup``, ``window``, ``traced``, ``free``, ``reference``) and its
``workloads/<cell>.json`` (with a ``rehearse`` block of its own where the
driver's name keys none in ``rehearsal.json``); a new per-layer metric
brings its reader ``metrics/<metric>.py``. ``rehearsal.json``'s defaults
reach a configuration only at the paths its ``run`` tree already holds, and
``Ctx`` builds nothing of a model family, so a configuration with no hash
grid and no volume bound reaches its driver as its file states it."""

import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from bench_torch import run
from bench_torch.reference import ngp

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


# ArcNerf's VolSDF lego recipe's model tree (configs/expr/NeRF/lego/nerf_lego_volsdf.yaml): a FreqEmbedder, a sphere
# bound, no hash grid and no volume
VOLSDF_MODEL = {
    "type": "VolSDF", "obj_bound": {"sphere": {"radius": 2.0}},
    "rays": {"radius_bound": 2.0, "n_sample": 64, "n_importance": 32, "n_eval": 128, "n_iter": 5, "beta_iter": 10,
             "eps": 0.1, "inverse_linear": False, "perturb": True, "add_inf_z": True, "noise_std": 0.0,
             "white_bkg": True},
    "params": {"speed_factor": 10, "beta_min": 0.0001, "init_beta": 0.1}, "chunk_rays": 4096, "chunk_pts": 131072,
    "geometry": {"W": 256, "D": 8, "skips": [4], "encoder": {"type": "FreqEmbedder", "input_dim": 3, "n_freqs": 6},
                 "W_feat": 256, "geometric_init": True, "radius_init": 0.5, "weight_norm": True,
                 "skip_reduce_output": True, "norm_skip": True, "act_cfg": {"type": "softplus", "beta": 100}},
    "radiance": {"mode": "pvnf", "W": 256, "D": 4,
                 "encoder": {"pts": {"type": "FreqEmbedder", "input_dim": 3, "n_freqs": 0},
                             "view": {"type": "FreqEmbedder", "input_dim": 3, "n_freqs": 4}},
                 "W_feat_in": 256, "weight_norm": True},
}

# A driver that imports nothing of the program: it holds the configuration and traffic trees to what their files
# and rehearse blocks state, and never reads ctx.spec.
PROBE_DRIVER = """import json

import torch


class Probe:
    def __init__(self, ctx):
        self.ctx = ctx
        tree = ctx.config
        assert "volume" not in tree["model"]["obj_bound"], tree["model"]["obj_bound"]
        assert "hashmap_size" not in json.dumps(tree), tree
        assert tree["model"]["rays"]["n_eval"] == 16 and tree["model"]["geometry"]["W"] == 32
        assert tree["n_rays"] == 256 and tree["model"]["rays"]["n_sample"] == 64
        assert ctx.workload["traffic"]["n_points"] == 64

    def setup(self):
        gen = torch.Generator().manual_seed(self.ctx.seed % 2**63)
        self.x = torch.rand(int(self.ctx.workload["traffic"]["n_points"]), 3, generator=gen) * 2 - 1

    def _work(self):
        self.sdf = torch.linalg.vector_norm(self.x, dim=-1) - 0.5

    def window(self, seconds):
        t0 = self.ctx.clock()
        self._work()
        return {"probe_points_per_s": len(self.x) / max(self.ctx.clock() - t0, 1e-9)}, 1, 0

    def traced(self, reading):
        with self.ctx.profiled(reading):
            self._work()
        reading["points"] = len(self.x)
        return 1, 0

    def free(self):
        assert "spec" not in vars(self.ctx)

    def reference(self):
        ref = (self.x ** 2).sum(-1).sqrt() - 0.5
        return {"sdf_gap": float((self.sdf - ref).abs().max())}


DRIVER = Probe
"""


def _files(root):
    """{path under root: sha256} of the benchmark's files, caches aside."""
    out = {}
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_configuration_with_no_hash_grid_comes_as_new_files_only(tmp_path):
    before = _files(os.path.join(ROOT, "bench_torch"))
    shutil.copytree(os.path.join(ROOT, "bench_torch"), tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "volsdf_probe", "source": "https://arxiv.org/abs/2106.12052",
                             "file": "bench_torch/configs/volsdf_probe.json", "reduced": [], "why": "a probe"})
    bench["workloads"].append({"name": "probe_volsdf", "config": "volsdf_probe", "traffic": "probe", "chips": 1,
                               "why": "a cell added as new files"})
    bench["end_to_end"].insert(0, {"name": "probe_points_per_s", "unit": "points/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock", "workloads": ["probe_volsdf"]})
    bench["per_layer"].append({"name": "points.probe", "unit": "points", "better": "higher",
                               "source": "program_counter", "layer": "probe", "moves": "probe_points_per_s",
                               "workloads": ["probe_volsdf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {
        "configs/volsdf_probe.json": {"name": "volsdf_probe", "source": "https://arxiv.org/abs/2106.12052",
                                      "reduced": [], "run": {"model": VOLSDF_MODEL, "n_rays": 1024},
                                      "rehearse": {"model.rays.n_eval": 16, "model.geometry.W": 32}},
        "workloads/probe_volsdf.json": {"config": "volsdf_probe", "driver": "probe", "chips": 1,
                                        "why": "a cell added as new files", "traffic": {"n_points": 4096},
                                        "rehearse": {"n_points": 64}, "limits": {"sdf_gap": 1e-6}},
    }
    for rel, tree in new.items():
        (tmp_path / "bench_torch" / rel).write_text(json.dumps(tree))
    (tmp_path / "bench_torch" / "drivers" / "probe.py").write_text(PROBE_DRIVER)
    (tmp_path / "bench_torch" / "metrics" / "points.probe.py").write_text("def read(r):\n    return r['points']\n")

    for trace in (0, 1):
        result, err = rehearse("probe_volsdf", trace, root=str(tmp_path))
        assert result["correct"] is True and result["failed"] == 0, err[-3000:]
        assert set(result["metrics"]) == ({"points.probe"} if trace else {"probe_points_per_s", "setup_s"})

    after = _files(str(tmp_path / "bench_torch"))
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new) | {"drivers/probe.py", "metrics/points.probe.py"}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert all(entry in bench[key] for entry in BENCH[key])

    # a driver whose run loads JAX: no result, and stderr names what it found
    (tmp_path / "bench_torch" / "drivers" / "probe.py").write_text(
        PROBE_DRIVER.replace("    def reference(self):\n",
                             "    def reference(self):\n        import sys, types\n"
                             "        sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"))
    proc = subprocess.run([sys.executable, str(tmp_path / "bench_torch" / "run.py"), "--workload", "probe_volsdf",
                           "--seed", "4000000007", "--seconds", "1", "--trace", "0", "--rehearse"],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0 and proc.stdout.strip() == "" and "loaded jax," in proc.stderr


def _old_load_cell(name, rehearse):
    """``run.load_cell`` as it read before configurations brought their own
    rehearsal: every key of ``rehearsal.json``'s config block written into
    the run tree, making whatever subtree it lacks."""
    def put(tree, dotted, value):
        keys = dotted.split(".")
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        tree[keys[-1]] = value

    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "bench_torch", "workloads", name + ".json")) as f:
        workload = json.load(f)
    if rehearse:
        with open(os.path.join(ROOT, "bench_torch", "rehearsal.json")) as f:
            tiny = json.load(f)
        for k, v in tiny["config"].items():
            put(config["run"], k, v)
        for k, v in tiny["traffic"].get(workload["driver"], {}).items():
            put(workload["traffic"], k, v)
    return config, workload


@pytest.mark.parametrize("rehearse_", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_the_cells_resolve_as_before(cell, rehearse_):
    bench, entry, config, workload = run.load_cell(cell, rehearse_)
    assert (bench, entry["name"]) == (BENCH, cell)
    assert (config, workload) == _old_load_cell(cell, rehearse_)


def _ctx(model):
    return run.Ctx(types.SimpleNamespace(seed=5), {"run": {"model": model}}, {}, None)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_ctx_spec_is_the_ngp_spec(config):
    model = run.load_cell(next(w["name"] for w in BENCH["workloads"] if w["config"] == config))[2]["run"]["model"]
    ctx = _ctx(model)
    assert "spec" not in vars(ctx)
    assert vars(ctx.spec) == vars(ngp.Spec(model)) and ctx.spec is ctx.spec


def test_ctx_builds_on_a_model_with_no_hash_grid():
    ctx = _ctx(VOLSDF_MODEL)
    assert ctx.model is VOLSDF_MODEL and "spec" not in vars(ctx)
    assert isinstance(type(ctx).spec, functools.cached_property)
    with pytest.raises(KeyError):
        ctx.spec
