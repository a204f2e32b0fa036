"""The port's strided training steps on the CPU (``progress.scan_steps``,
``ArcNerfTrainer.train_steps``, ``trainer.step_graph.StepGraph``).

- ``_stride_for`` gives the strides of the JAX trainer's ``_stride_for``.
- The static-buffer step that a stride runs (replays of a CUDA graph on
  the card; the same function on the CPU) is the eager per-step path bit
  for bit, with the generators seeded alike: losses, parameters, Adam
  state, EMA, the generator's final state, the ray picks and the recorded
  valid-sample counts - over a stride that crosses a MultiStepLR boundary,
  after an occupancy update between strides, and after a resume.
- ``train()`` with scan_steps 4 and 1 writes the same checkpoints and ends
  with the same parameters.
- The constants made once a device give the values the expressions they
  replace gave.
"""

import os
import types

import numpy as np
import pytest
import torch

from arcnerf_tpu.trainer.trainer import ArcNerfTrainer as JaxTrainer
from arcnerf_torch.geometry.ray import sphere_ray_intersection
from arcnerf_torch.geometry.volume import Volume
from arcnerf_torch.trainer import ArcNerfTrainer
from arcnerf_torch.trainer.pipeline import Pipeline
from arcnerf_torch.utils.cfgs import dict_to_obj, load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.device_consts import device_constant
from test_torch_slice import CFG
from test_torch_train_slice import SMALL_RUN

torch.set_num_threads(1)

# MultiStepLR boundaries at updates 2 and 6, an EMA, occupancy updates every
# 4 steps (regular ones, drawn from the generator, from step 4), and the
# dynamic batch size every 4
STRIDED = SMALL_RUN + ["--optim.lr_scheduler.lr_steps", "[2,6]", "--optim.ema_decay", "0.9",
                       "--model.obj_bound.epoch_optim", "4", "--model.obj_bound.epoch_optim_warmup", "2",
                       "--dataset.train.scheduler.dynamic_batch_size.update_epoch", "4"]


@pytest.mark.parametrize("scan_steps", [1, 4, 16])
@pytest.mark.parametrize("cadences", [(200, -1, 5000, 16, 16), (5, 6, None, 16, 4), (50, -1, -1, None, 16),
                                      (100, 250, 7, 16, 16)])
def test_stride_for_matches_jax(scan_steps, cadences):
    for total in (20, 400, 5000):
        stand_in = types.SimpleNamespace(scan_steps=scan_steps, total_epoch=total)
        for epoch in (0, 1, 5, 15, 16, 17, 19, 31, 249, 399):
            if epoch >= total:
                continue
            want = JaxTrainer._stride_for(stand_in, epoch, cadences)
            assert ArcNerfTrainer._stride_for(stand_in, epoch, cadences) == want, (total, epoch)


def _trainer(tmp_path, name, scan_steps, extra=()):
    cfgs = update_configs_by_dotlist(load_configs(CFG), STRIDED + list(extra) + [
        "--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps", str(scan_steps)])
    return ArcNerfTrainer(cfgs)


def _eager(trainer, epochs):
    picks = []
    for e in epochs:
        trainer.train_steps(e, 1)
        picks.append(trainer.pipeline.last_picks.clone())
    return picks


def _strided(trainer, epoch0, stride):
    trainer.train_steps(epoch0, stride)
    graph = trainer.step_graphs[(trainer.pipeline.n_rays, None)]
    return list(graph.picks[:stride].clone())


def _assert_same(eager, strided, picks_e, picks_s):
    assert len(eager.loss_history) == len(strided.loss_history)
    assert torch.equal(torch.stack(eager.loss_history), torch.stack(strided.loss_history))
    assert eager.step == strided.step and float(eager._updates) == float(strided._updates) == eager.step
    assert all(torch.equal(a, b) for a, b in zip(picks_e, picks_s)) and len(picks_e) == len(picks_s)
    strided_params = dict(strided.model.named_parameters())
    for name, p in eager.model.named_parameters():
        assert torch.equal(p, strided_params[name]), name
    adam_s = strided.adam_state()
    for name, state in eager.adam_state().items():
        for k, v in state.items():
            assert torch.equal(v, adam_s[name][k]), (name, k)
    for name, v in eager.ema.items():
        assert torch.equal(v, strided.ema[name]), name
    for k, v in eager.bound_state["fg"].items():
        assert torch.equal(v, strided.bound_state["fg"][k]), k
    assert torch.equal(eager.generator.get_state(), strided.generator.get_state())
    counts_e = [float(c) for c, _ in eager.pipeline._measured]
    counts_s = [float(c) for c, _ in strided.pipeline._measured]
    # a copy per step from the stats ring: no record aliases another
    assert counts_e == counts_s and len(set(counts_s)) == len(counts_s) > 1


@pytest.mark.parametrize("case", ["lr_boundary", "occupancy_update", "resume"])
def test_strided_steps_equal_the_eager_steps_bitwise(case, tmp_path):
    eager, strided = _trainer(tmp_path, "eager", 1), _trainer(tmp_path, "strided", 4)
    picks_e = _eager(eager, range(4))
    picks_s = _strided(strided, 0, 4)
    if case == "lr_boundary":
        # updates 0-1 at lr, 2-3 at lr * 0.33: the last rate set in the stride
        assert float(strided.optimizer.param_groups[0]["lr"]) == float(np.float32(1e-2 * 0.33))
        assert float(strided.lr_schedule(0)) == float(np.float32(1e-2))  # the rates' table is unchanged
    if case in ("occupancy_update", "resume"):
        bitfield = strided.bound_state["fg"]["bitfield"]
        before = bitfield.clone()
        picks_e += _eager(eager, range(4, 8))
        picks_s += _strided(strided, 4, 4)  # the occupancy update at 4 runs before the stride
        assert strided.bound_state["fg"]["bitfield"] is bitfield and not torch.equal(bitfield, before)
    if case == "resume":
        for trainer in (eager, strided):
            trainer.save(["at8"], 8)
            trainer.train_steps(8, 4)
            trainer.resume_from(os.path.join(trainer.ckpt_dir, "at8.pt"))
            trainer.loss_history = trainer.loss_history[:8]
        assert strided.step == 8 and not strided.step_graphs  # the old tensors' graphs are dropped
        picks_e += _eager(eager, range(8, 12))
        picks_s += _strided(strided, 8, 4)
    _assert_same(eager, strided, picks_e, picks_s)


def test_train_with_scan_steps_matches_per_step_training(tmp_path):
    from arcnerf_torch import train

    runs = {}
    for scan in (1, 4):
        expr = tmp_path / "scan{}".format(scan)
        runs[scan] = train.main(["--configs", CFG, "--dir.expr_dir", str(expr)] + STRIDED + [
            "--progress.epoch", "12", "--progress.epoch_loss", "5", "--progress.epoch_save_checkpoint", "6",
            "--progress.epoch_val", "6", "--progress.scan_steps", str(scan)])
        assert runs[scan].step == 12 and len(runs[scan].loss_history) == 12
        assert sorted(os.listdir(expr / "checkpoints")) == ["final.pt", "latest.pt", "model_step12.pt",
                                                           "model_step6.pt"]
    assert torch.equal(torch.stack(runs[1].loss_history), torch.stack(runs[4].loss_history))
    params4 = dict(runs[4].model.named_parameters())
    for name, p in runs[1].model.named_parameters():
        assert torch.equal(p, params4[name]), name
    for name in ("model_step6.pt", "final.pt"):
        one, four = (torch.load(tmp_path / "scan{}".format(s) / "checkpoints" / name) for s in (1, 4))
        assert one["step"] == four["step"]
        for k, v in one["state_dict"].items():
            assert torch.equal(v, four["state_dict"][k]), (name, k)


def _volume_range():
    vol = Volume(n_grid=16, origin=(0.1, -0.2, 0.0), side=2.0)
    return vol.get_range(), torch.as_tensor(vol.get_range_np(), dtype=torch.float32), vol.get_range()


def _voxel_size():
    vol = Volume(n_grid=24, origin=(0.0, 0.0, 0.0), xyz_len=(2.0, 3.0, 1.5))
    old = torch.as_tensor(vol.xyz_len / vol.n_grid, dtype=torch.float32)
    return vol.get_voxel_size(to_list=False), old, vol.get_voxel_size(to_list=False)


def _bkg_color():
    color = [0.2, 0.5, 1.0]
    pipe = Pipeline(dict_to_obj({"bkg_color": {"color": color}}), 8, "cpu")
    batch = {"img": torch.rand(1, 8, 3), "mask": torch.rand(1, 8), "rays_o": torch.zeros(1, 8, 3)}
    got = pipe.composite_bkg_color(dict(batch))["bkg_color"]
    again = pipe.composite_bkg_color(dict(batch))["bkg_color"]
    return got, torch.as_tensor(color, dtype=torch.float32).expand(1, 8, 3), again


def _invalid_ray_fill():
    from arcnerf_torch.models import build_model

    model = build_model(update_configs_by_dotlist(load_configs(CFG), SMALL_RUN))
    fg = model.fg_model
    out = {"rgb": torch.rand(6, 3), "depth": torch.rand(6), "mask": torch.rand(6)}
    mask = torch.tensor([True, False, True, False, False, True])
    filled = fg.update_values_for_invalid_rays(out, mask)["rgb"]
    old = torch.as_tensor(fg.get_render_cfgs("bkg_color"), dtype=torch.float32).expand(6, 3)
    return filled, torch.where(mask[:, None], out["rgb"], old), fg.update_values_for_invalid_rays(out, mask)["rgb"]


def _sphere():
    rng = np.random.default_rng(3)
    rays_o = torch.from_numpy(rng.normal(size=(32, 3)).astype(np.float32) * 2)
    rays_d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(32, 3)).astype(np.float32)), dim=-1)
    got = torch.cat(sphere_ray_intersection(rays_o, rays_d, 1.3, origin=(0.1, 0.0, -0.2))[:2], 1)
    # the tensor path keeps the old torch.as_tensor(radius, dtype) of the value
    old = torch.cat(sphere_ray_intersection(rays_o, rays_d, torch.tensor([1.3]), origin=(0.1, 0.0, -0.2))[:2], 1)
    assert torch.equal(device_constant((0.1, 0.0, -0.2)), torch.as_tensor((0.1, 0.0, -0.2), dtype=torch.float32))
    return got, old, torch.cat(sphere_ray_intersection(rays_o, rays_d, 1.3, origin=(0.1, 0.0, -0.2))[:2], 1)


@pytest.mark.parametrize("site", [_volume_range, _voxel_size, _bkg_color, _invalid_ray_fill, _sphere],
                         ids=["volume_range", "voxel_size", "fixed_bkg_color", "invalid_ray_fill", "sphere"])
def test_device_constants_give_the_old_values(site):
    got, old, again = site()
    assert got.dtype == old.dtype and torch.equal(got, old)
    assert torch.equal(again, got)
