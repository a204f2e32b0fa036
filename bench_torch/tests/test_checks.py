"""The check that decides ``correct`` fails where it must, at the
rehearsal's tiny sizes on the CPU: the control (the reference a precision
below the configuration's, in the program's place) fails a number of each
cell; and a run with the timed path broken underneath comes out not
correct, once for each fault a cell can have (a step that leaves its state
unchanged, the occupancy update's too; half the batch left out, the mean
over the rest; an answer altered where it is produced, a pixel or a
voxel). On one chip there is no exchange to leave out.
"""

import io
import json

import pytest
import torch

from bench_torch import controls, run

SEEDS = (4100000001, 4100000002, 4100000003)


def limits(cell):
    return run.load_cell(cell)[3]["limits"]


def fails(numbers, lim):
    return any(numbers[k] > lim[k] for k in lim)


@pytest.mark.parametrize("cell", ["train_ngp_quad", "serve_exact_ngp_quad", "serve_windowed_ngp_quad"])
def test_the_control_fails(cell, capsys):
    controls.main(["--workload", cell, "--seeds", *map(str, SEEDS), "--rehearse"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    control = [x for x in lines if x["reading"] == "control"]
    assert len(control) == len(SEEDS)
    for x in control:
        assert fails(x["numbers"], limits(cell)), x


def run_cell(cell, seed=4100000011):
    out = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0", "--rehearse"],
                    out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert run_cell("train_ngp_quad")["correct"] is False


def test_an_occupancy_update_that_leaves_its_grid_unchanged(monkeypatch):
    from arcnerf_torch.models.base_modules.obj_bound import VolumeBound

    monkeypatch.setattr(VolumeBound, "optimize", lambda self, state, *args, **kwargs: state)
    assert run_cell("train_ngp_quad")["correct"] is False


def test_an_occupancy_grid_altered_where_it_is_produced(monkeypatch):
    from arcnerf_torch.models.base_modules.obj_bound import VolumeBound

    inner = VolumeBound.optimize

    def altered(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        bits = out["bitfield"].clone()
        bits.view(-1)[bits.numel() // 2] ^= True  # one voxel
        return dict(out, bitfield=bits)

    monkeypatch.setattr(VolumeBound, "optimize", altered)
    assert run_cell("train_ngp_quad")["correct"] is False


def test_half_the_batch_left_out(monkeypatch):
    from arcnerf_torch import losses

    whole = losses.ImgLoss.__call__

    def half(self, inputs, output):
        n = inputs["img"].shape[1] // 2
        return whole(self, {k: v[:, :n] if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in inputs.items()},
                     {k: v[:, :n] if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in output.items()})

    monkeypatch.setattr(losses.ImgLoss, "__call__", half)
    assert run_cell("train_ngp_quad")["correct"] is False


@pytest.mark.parametrize("cell,method", [("serve_exact_ngp_quad", "render_image"),
                                         ("serve_windowed_ngp_quad", "render_image_windowed")])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell, method):
    from arcnerf_torch.render.engine import RenderEngine

    inner = getattr(RenderEngine, method)

    def altered(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        imgs = out[0] if isinstance(out, tuple) else out
        rgb = imgs["rgb"].clone()
        rgb.view(-1)[rgb.numel() // 2] += 0.1  # one pixel's colour
        imgs["rgb"] = rgb
        return out

    monkeypatch.setattr(RenderEngine, method, altered)
    assert run_cell(cell)["correct"] is False
