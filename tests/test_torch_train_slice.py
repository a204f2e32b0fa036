"""The arcnerf_torch training slice as a whole vs the JAX package (CPU).

A JAX ArcNerfTrainer at the small size of test_torch_slice.py runs five
steps of ``_train_step`` on fed batches, from seeded params and the
spheres' occupancy, with perturb off and no sigma noise, so that the only
draws are the batches themselves. 256 rays x 64 samples exceed the 2^12
point budget, so both packages take the compacted path. The port's
trainer, given the same params (``state_from_jax``) and batches, must
follow: step 1's gradients per tensor, the loss over five steps, and a
resume from the JAX state after two steps (params and Adam state bridged
by ``adam_state_from_jax``). The same five batches also go through the JAX
trainer's strided step (``_scan_steps_fn``, one ``lax.scan``) and the
port's (``train_steps(0, 5, feeds=...)``, its static-buffer step). Then the
entry: ``python -m
arcnerf_torch.train`` on the CPU writes a checkpoint that
``arcnerf_torch.evaluate`` loads, and ``--resume`` continues it.

The expected source of difference is the MLP backward: the JAX CPU trainer
runs the XLA MLP backend, whose autodiff rounds cotangents to bf16, while
the port follows the Pallas backward (kernel D's rounding).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.parallel.mesh import shard_batch, shard_stacked_batch
from arcnerf_tpu.trainer import ArcNerfTrainer as JaxTrainer
from arcnerf_tpu.utils.cfgs import load_configs as jax_load_configs
from arcnerf_tpu.utils.cfgs import update_configs_by_dotlist as jax_update
from arcnerf_torch.trainer import ArcNerfTrainer
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import adam_state_from_jax, state_from_jax
from test_torch_slice import CFG, SMALL, seeded_params, sphere_bound_state

torch.set_num_threads(1)

N_STEPS, N_RAYS = 5, 256
# step-1 gradients per tensor (relative norm error) and the loss per step
# (relative): the slack covers XLA's bf16 cotangents in the JAX MLP backward
GRAD_REL, LOSS_REL = 5e-2, 2e-2
TRAIN = ["--model.rays.perturb", "False", "--model.rays.noise_std", "0.0", "--dataset.train.n_imgs", "2",
         "--dataset.train.wh", "[16,16]", "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]",
         "--n_rays", str(N_RAYS), "--dist.rng_impl", "threefry2x32"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _adam_moments(opt_state):
    """(count, mu, nu) of the optax Adam state inside the trainer's chain."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
            return int(s.count), to_np(s.mu), to_np(s.nu)
    raise AssertionError("no Adam state in the optimizer state")


def _batches(pool, seed=0):
    """N_STEPS batches drawn with numpy from the JAX trainer's ray pool: ray
    picks with replacement and random background colours composited under
    the masks (Pipeline.fetch_step_bkg_color)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        sel = rng.integers(0, pool["rays_o"].shape[0], size=N_RAYS)
        batch = {k: v[sel][None].astype(np.float32) for k, v in pool.items()}
        color = rng.random((1, N_RAYS, 3)).astype(np.float32)
        mask = batch["mask"][..., None]
        batch["img"] = batch["img"] * mask + color * (1.0 - mask)
        batch["bkg_color"] = color
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Five JAX train steps from seeded params: the batches, the losses, the
    gradients of step 1 (Adam's first moment / 0.1), the state (params,
    Adam moments) after steps 2 and 3, and the losses of the same five
    steps as one stride of ``_scan_steps_fn``."""
    cfgs = jax_update(jax_load_configs(CFG), SMALL + TRAIN + [
        "--dir.expr_dir", str(tmp_path_factory.mktemp("jax_expr"))])
    trainer = JaxTrainer(cfgs)
    params = jax.tree_util.tree_map(jnp.asarray, seeded_params(trainer.state["params"]))
    bound_np = sphere_bound_state()

    def fresh_state():  # a copy of its own: the steps donate their state
        state = dict(trainer.state, params=params, opt_state=trainer.tx.init(params),
                     bound_state=jax.tree_util.tree_map(jnp.asarray, bound_np))
        return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True) if isinstance(x, jax.Array) else x, state)

    state = fresh_state()
    batches = _batches(trainer.pipeline.data)
    run = {"batches": batches, "losses": [], "bound": bound_np,
           "params0": jax.tree_util.tree_map(np.asarray, params)}
    for t, batch in enumerate(batches):
        feed = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, trainer.mesh)
        state, stats = trainer._train_step(state, feed, jax.random.PRNGKey(t), t)
        run["losses"].append(float(stats["loss"]))
        count, mu, nu = _adam_moments(state["opt_state"])
        if t == 0:
            run["grads"] = jax.tree_util.tree_map(lambda m: m / 0.1, mu)
            run["n_valid"] = int(stats["n_valid_pts"])
        if t in (1, 2):
            run["state{}".format(t + 1)] = (jax.tree_util.tree_map(np.asarray, state["params"]), count, mu, nu)
    feed_stack = shard_stacked_batch({k: np.stack([b[k] for b in batches]) for k in batches[0]}, trainer.mesh)
    keys = jnp.stack([jax.random.PRNGKey(t) for t in range(N_STEPS)])
    _, stats_seq = trainer._scan_steps_fn(fresh_state(), feed_stack, keys, 0)
    run["scan_losses"] = np.asarray(stats_seq["loss"]).tolist()
    run["scan_n_valid"] = np.asarray(stats_seq["n_valid_pts"]).tolist()
    return run


def _port_trainer(tmp_path, params_np, bound_np, extra=()):
    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL + TRAIN + list(extra) + [
        "--device", "cpu", "--dir.expr_dir", str(tmp_path / "port_expr")])
    trainer = ArcNerfTrainer(cfgs)
    state, bound = state_from_jax(params_np, bound_np)
    trainer.model.load_state_dict(state)
    trainer.bound_state = bound
    return trainer


def _feed(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_step_gradients_and_loss_curve_track_jax(jax_run, tmp_path):
    assert jax_run["n_valid"] > 0 and N_RAYS * 64 > 1 << 12  # compacted path, real samples
    trainer = _port_trainer(tmp_path, jax_run["params0"], jax_run["bound"])
    losses = []
    for t, batch in enumerate(jax_run["batches"]):
        stats = trainer.train_step(t, feed=_feed(batch))
        losses.append(float(stats["loss"]))
        if t == 0:
            assert int(stats["n_valid_pts"]) == jax_run["n_valid"]
            port_grads, _ = state_from_jax(jax_run["grads"], {})
            adam = trainer.adam_state()
            for name, want in port_grads.items():
                got = adam[name]["exp_avg"] / 0.1
                assert float(want.abs().sum()) > 0, name
                assert _rel(got.numpy(), want.numpy()) < GRAD_REL, (name, _rel(got.numpy(), want.numpy()))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_REL)
    assert losses[-1] < losses[0]


def test_strided_steps_track_the_jax_scan(jax_run, tmp_path):
    # the five fed batches as one stride of the port's static-buffer step
    # against one lax.scan of the JAX trainer's step, from the same params
    assert len(set(jax_run["scan_n_valid"])) > 1  # five different batches
    trainer = _port_trainer(tmp_path, jax_run["params0"], jax_run["bound"], ["--progress.scan_steps", str(N_STEPS)])
    stats = trainer.train_steps(0, N_STEPS, feeds=[_feed(b) for b in jax_run["batches"]])
    assert trainer.step == N_STEPS and len(trainer.loss_history) == N_STEPS
    assert int(stats["n_valid_pts"]) == jax_run["scan_n_valid"][-1]
    losses = [float(v) for v in trainer.loss_history]
    np.testing.assert_allclose(losses, jax_run["scan_losses"], rtol=LOSS_REL)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_REL)
    # Adam's first moment after step 1 of a stride (the scan's step 1 is
    # the JAX step of jax_run)
    trainer = _port_trainer(tmp_path, jax_run["params0"], jax_run["bound"], ["--progress.scan_steps", str(N_STEPS)])
    trainer.train_steps(0, 1, feeds=[_feed(jax_run["batches"][0])])
    port_grads, _ = state_from_jax(jax_run["grads"], {})
    adam = trainer.adam_state()
    for name, want in port_grads.items():
        got = adam[name]["exp_avg"] / 0.1
        assert _rel(got.numpy(), want.numpy()) < GRAD_REL, (name, _rel(got.numpy(), want.numpy()))


def test_resume_from_a_bridged_jax_state(jax_run, tmp_path):
    # params and Adam state after two JAX steps -> the port runs steps 3-5
    params2, count, mu, nu = jax_run["state2"]
    trainer = _port_trainer(tmp_path, params2, jax_run["bound"])
    trainer.load_adam_state(adam_state_from_jax(count, mu, nu))
    trainer.step = count
    assert count == 2
    losses = [float(trainer.train_step(t, feed=_feed(jax_run["batches"][t]))["loss"]) for t in range(2, N_STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"][2:], rtol=LOSS_REL)
    # after step 3 the port's params must not have moved further from the
    # JAX params after step 3 than its step-3 update is large
    params3, _, _, _ = jax_run["state3"]
    trainer = _port_trainer(tmp_path, params2, jax_run["bound"])
    trainer.load_adam_state(adam_state_from_jax(count, mu, nu))
    trainer.step = count
    trainer.train_step(2, feed=_feed(jax_run["batches"][2]))
    want3, _ = state_from_jax(params3, {})
    want2, _ = state_from_jax(params2, {})
    got3 = dict(trainer.model.named_parameters())
    for name in want3:
        step_j = want3[name] - want2[name]
        step_p = got3[name].detach() - want2[name]
        assert _rel(step_p.numpy(), step_j.numpy()) < GRAD_REL * 2, name


SMALL_RUN = SMALL + ["--device", "cpu", "--dataset.train.n_imgs", "3", "--dataset.train.wh", "[16,16]",
                     "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]", "--n_rays", "256",
                     "--progress.epoch_loss", "10", "--progress.epoch_val", "20",
                     "--progress.epoch_save_checkpoint", "-1", "--model.obj_bound.epoch_optim_warmup", "16"]


def test_train_entry_writes_a_checkpoint_evaluate_loads_and_resume_continues(tmp_path):
    from arcnerf_torch import evaluate, train

    argv = ["--configs", CFG, "--dir.expr_dir", str(tmp_path / "expr"), "--progress.epoch", "20"] + SMALL_RUN
    trainer = train.main(argv)
    ckpt = tmp_path / "expr" / "checkpoints" / "final.pt"
    assert os.path.exists(ckpt) and trainer.step == 20
    losses = torch.stack(trainer.loss_history)
    assert torch.isfinite(losses).all() and losses.shape == (20,)
    # updates at 16 (warmup below 16 is none: 16 is the first, regular one)
    assert not bool(trainer.bound_state["fg"]["bitfield"].all())

    summary, results = evaluate.main([
        "--configs", CFG, "--model_pt", str(ckpt), "--device", "cpu", "--dir.eval_dir", str(tmp_path / "eval"),
        "--dataset.eval.type", "Synthetic", "--dataset.eval.n_imgs", "1", "--dataset.eval.wh", "[16,16]",
        "--dataset.eval.cam_radius", "2.5", "--dataset.eval.white_bkg", "True", "--progress.max_samples_eval", "1"]
        + SMALL)
    assert results[0]["rgb"].shape == (16, 16, 3) and np.isfinite(summary["psnr"])

    resumed = train.main(argv + ["--resume", str(ckpt), "--progress.epoch", "24"])
    assert resumed.start_epoch == 20 and resumed.step == 24 and len(resumed.loss_history) == 4
    first = dict(trainer.model.named_parameters())
    for name, p in resumed.model.named_parameters():
        assert not torch.equal(p.detach(), first[name].detach()), name  # it trained on from the checkpoint
    adam = resumed.adam_state()
    assert all(int(s["step"]) == 24 for s in adam.values())


def test_ema_renders_with_the_shadow_and_restores_the_live_params(tmp_path):
    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL_RUN + [
        "--optim.ema_decay", "0.9", "--dir.expr_dir", str(tmp_path / "ema")])
    trainer = ArcNerfTrainer(cfgs)
    for t in range(3):
        trainer.train_step(t)
    live = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    shadow = trainer.eval_params()
    assert any(not torch.equal(shadow[k], live[k]) for k in live)  # the shadow lags the live params
    sample = trainer.data["val"][0]
    rendered = trainer.render_image(sample)["rgb"]
    for k, v in trainer.model.named_parameters():
        assert torch.equal(v.detach(), live[k]), k  # restored after the render
    params = dict(trainer.model.named_parameters())
    with torch.no_grad():
        for k, v in shadow.items():
            params[k].copy_(v)
        want = trainer.engine.render_image(sample, trainer._val_chunk_rays())["rgb"]
    assert torch.equal(rendered, want)


def test_unported_training_options_raise(tmp_path):
    for extra, match in ((["--dist.model_parallel", "2"], "model_parallel"),
                         (["--optim.clip_gradients", "1.0"], "clip_gradients"),
                         (["--dataset.train.scheduler.precrop.ratio", "0.5",
                           "--dataset.train.scheduler.precrop.max_epoch", "10"], "precrop")):
        cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL_RUN + extra + [
            "--dir.expr_dir", str(tmp_path / "x")])
        with pytest.raises(NotImplementedError, match=match):
            ArcNerfTrainer(cfgs)
