"""The ``train_volsdf`` cell of the benchmark (``bench_torch``) end to end on
the CPU at its rehearsal's tiny sizes: untraced and traced runs come out
correct, the traced one with the cell's three per-layer metrics; the check
fails where it must, for the control (the reference with the GeoNet's
matmuls in TF32, in the program's place) and for each fault planted in the
program (the eikonal loss left out, one bisection of beta fewer, one round
of Algorithm 1 fewer, half the batch left out, a step that leaves its state
unchanged); the yardstick counts the recipe's GEMM operations; and the
host operators' time stands in for the device's on the CPU alone."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_torch import controls_volsdf, roofline_volsdf, run
from bench_torch.drivers import train_volsdf

CELL = "train_volsdf"
SEEDS = (4100000001, 4100000002)


def limits():
    return run.load_cell(CELL)[3]["limits"]


def rehearse(trace):
    proc = subprocess.run([sys.executable, os.path.join(run.ROOT, "bench_torch", "run.py"), "--workload", CELL,
                           "--seed", "4000000007", "--seconds", "0.5", "--trace", str(trace), "--rehearse"],
                          capture_output=True, text=True, timeout=300, cwd=run.ROOT,
                          env=dict(os.environ, PYTHONPATH=run.ROOT, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_rehearses_correct(trace):
    result = rehearse(trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["check"]) == set(limits())
    want = {"gemm_roofline.volsdf", "plain_ms.volsdf", "mfu.volsdf"} if trace else {"train_rays_per_s", "setup_s"}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_the_control_fails(capsys):
    controls_volsdf.main(["--workload", CELL, "--seeds", *map(str, SEEDS), "--rehearse"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    lim = limits()
    for x in lines:
        assert any(x["numbers"][k] > lim[k] for k in lim), x
    assert sum(x["reading"] == "control" for x in lines) == len(SEEDS)


# each fault planted in the program of a run of its own (this process holds
# JAX, which a run refuses to share): code that patches the program, then the run
FAULTS = {
    "no_eikonal": """
from arcnerf_torch import losses
losses.EikonalLoss.__call__ = lambda self, inputs, output: torch.zeros(())
""",
    "beta_iter_9": """
from arcnerf_torch.models.volsdf_model import VolSDF
inner = VolSDF.__init__
def init(self, *args, **kwargs):
    inner(self, *args, **kwargs)
    self.beta_iter -= 1
VolSDF.__init__ = init
""",
    "n_iter_4": """
from arcnerf_torch.models.volsdf_model import VolSDF
inner = VolSDF.__init__
def init(self, *args, **kwargs):
    inner(self, *args, **kwargs)
    self.n_iter -= 1
VolSDF.__init__ = init
""",
    "half_batch": """
from arcnerf_torch import losses
whole = losses.ImgLoss.__call__
def half(self, inputs, output):
    n = inputs["img"].shape[1] // 2
    cut = lambda d: {k: v[:, :n] if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in d.items()}
    return whole(self, cut(inputs), cut(output))
losses.ImgLoss.__call__ = half
""",
    "state_unchanged": """
torch.optim.Adam.step = lambda self, closure=None: None
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_comes_out_not_correct(fault):
    code = "import sys\nimport torch\n{}\nfrom bench_torch import run\nsys.exit(run.main(sys.argv[1:]))\n".format(
        FAULTS[fault])
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seed", "4100000011", "--seconds", "0.3",
                           "--trace", "0", "--rehearse"], capture_output=True, text=True, timeout=300, cwd=run.ROOT,
                          env=dict(os.environ, PYTHONPATH=run.ROOT, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False


def test_the_yardstick_counts_the_recipes_gemm_operations():
    # 2, 12 and 6 operations a weight: the sampler's 640 points a ray through
    # the GeoNet's forward, the 98 sample and eikonal points' forward, input
    # gradient and both backwards, the 96 samples' radiance forward and
    # backward; 1.48 TFLOP for 1024 rays
    model = run.load_cell(CELL)[2]["run"]["model"]
    geo, rad = roofline_volsdf.chains(model)
    assert roofline_volsdf.weights(geo) == 524544 and roofline_volsdf.weights(rad) == 271360
    assert geo[0] == (39, 256) and geo[4] == (256, 217) and geo[5] == (256, 256) and rad[0] == (289, 256)
    flops = roofline_volsdf.flops(model, 1024 * 640, 1024 * 98)
    assert flops == 1024 * (640 * 2 * 524544 + 98 * 12 * 524544 + 96 * 6 * 271360)
    assert round(flops / 1e12, 2) == 1.48
    least = roofline_volsdf.least_seconds(model, 1024 * 640, 1024 * 98)
    assert flops / 67e12 <= least <= 1.05 * flops / 67e12


def test_the_host_time_stands_in_for_the_device_on_the_cpu_alone():
    # a window whose trace holds host operators and no device event
    host = SimpleNamespace(device_type=torch.autograd.DeviceType.CPU, time_range=SimpleNamespace(start=0, end=10))
    events = [SimpleNamespace(name="aten::mm", self_cpu_time_total=3e6, **vars(host)),
              SimpleNamespace(name="aten::add", self_cpu_time_total=1e6, **vars(host))]
    prof = SimpleNamespace(events=lambda: events)
    assert train_volsdf.kernel_seconds(prof, torch.device("cpu")) == (3.0, 1.0)
    with pytest.raises(RuntimeError, match="no device operation"):
        train_volsdf.kernel_seconds(prof, torch.device("cuda", 0))
