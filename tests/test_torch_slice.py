"""The arcnerf_torch serving slice as a whole vs the JAX package (CPU): the
NGP FullModel forward at a small size on bridged params, and the
import guard that keeps JAX out of the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.models import build_model as jax_build_model
from arcnerf_tpu.utils.cfgs import load_configs as jax_load_configs
from arcnerf_tpu.utils.cfgs import update_configs_by_dotlist as jax_update
from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
from arcnerf_torch.models import build_model
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import state_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml")
# 4 levels over T = 2^12 (level 0 dense, 1-3 hashed), 16-wide nets,
# n_grid 16, 64 samples per ray, a point budget of 2^12
SMALL = ["--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
         "--model.geometry.W", "16", "--model.radiance.W", "16", "--model.obj_bound.volume.n_grid", "16",
         "--model.rays.n_sample", "64", "--model.obj_bound.log_max_allowance", "12"]
# bf16 flips in the MLPs, amplified by TruncExp, bound the slice's agreement
RGB_MAX, RGB_MEAN, DEPTH_MAX = 2e-2, 1e-3, 5e-2


def seeded_params(template, seed=0):
    """numpy params shaped like a JAX param tree: table entries in
    [-0.5, 0.5], dense kernels ~ N(0, 1/fan_in), the density column of the
    geometry head scaled by 3 so the scene is far from transparent."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = np.shape(leaf)
        if names[-1] == "embeddings":
            return rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)
        w = rng.normal(size=shape) / np.sqrt(shape[0])
        if "coarse_geo_net" in names and "fc_out" in names:
            w[:, 0] *= 3.0
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def jax_model_and_params(argv, seed=0):
    cfgs = jax_update(jax_load_configs(CFG), list(argv))
    model = jax_build_model(cfgs)
    tiny = {"rays_o": jnp.zeros((1, 2, 3)), "rays_d": jnp.ones((1, 2, 3)) / np.sqrt(3.0)}
    variables = jax.jit(lambda rngs, feed: model.init(rngs, feed, inference_only=True,
                                                     bound_state=model.init_bound_state()))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, tiny)
    return cfgs, model, seeded_params(variables["params"], seed)


def sphere_bound_state(n_grid=16):
    return {"fg": {"bitfield": sphere_scene_bitfield(n_grid, 2.0),
                   "opafield": np.zeros((n_grid,) * 3, np.float32)}}


def view_rays(wh=16):
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.utils.cfgs import dict_to_obj

    ds = get_dataset(dict_to_obj({"eval": {"type": "Synthetic", "n_imgs": 1, "wh": [wh, wh], "cam_radius": 2.5,
                                           "white_bkg": True, "center_pixel": True}}), "data", "eval")
    sample = ds[0]
    return sample["rays_o"], sample["rays_d"]


def assert_slice_close(got, want):
    d_rgb = np.abs(got["rgb"] - want["rgb"])
    d_mask = np.abs(got["mask"] - want["mask"])
    assert d_rgb.max() <= RGB_MAX and d_rgb.mean() <= RGB_MEAN, (d_rgb.max(), d_rgb.mean())
    assert d_mask.max() <= RGB_MAX and d_mask.mean() <= RGB_MEAN, (d_mask.max(), d_mask.mean())
    assert np.abs(got["depth"] - want["depth"]).max() <= DEPTH_MAX


@pytest.mark.parametrize("extra,bkg", [
    ([], None),
    (["--model.obj_bound.eval_max_pts_per_ray", "8"], (1.0, 1.0, 1.0)),  # per-ray cap, budget shrink
    (["--model.obj_bound.log_max_allowance", "10"], None),  # a budget below the valid count clips the stream
])
def test_full_model_forward_matches_jax(extra, bkg):
    argv = SMALL + extra
    cfgs_j, model_j, params = jax_model_and_params(argv)
    bound_np = sphere_bound_state()
    ro, rd = view_rays()
    feed = {"rays_o": ro[None], "rays_d": rd[None]}
    if bkg is not None:
        feed["bkg_color"] = np.broadcast_to(np.asarray(bkg, np.float32), ro.shape)[None].copy()

    bound_j = jax.tree_util.tree_map(jnp.asarray, bound_np)
    out_j = jax.jit(lambda p, f: model_j.apply({"params": p}, f, inference_only=True, bound_state=bound_j))(
        params, {k: jnp.asarray(v) for k, v in feed.items()})

    cfgs = update_configs_by_dotlist(load_configs(CFG), list(argv))
    model = build_model(cfgs)
    state, bound = state_from_jax(jax.tree_util.tree_map(np.asarray, params), bound_np)
    model.load_state_dict(state)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in feed.items()}, inference_only=True, bound_state=bound)

    got = {k: out[k][0].numpy() for k in ("rgb", "depth", "mask")}
    want = {k: np.asarray(out_j[k][0]) for k in ("rgb", "depth", "mask")}
    assert got["rgb"].shape == (256, 3) and 0.05 < want["mask"].mean() < 0.95  # compaction does real work
    assert int(out["n_valid_pts"]) == int(out_j["n_valid_pts"])
    if "10" in extra:
        assert int(out["n_valid_pts"]) > 1 << 10  # more valid samples than the budget holds
    assert_slice_close(got, want)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import arcnerf_torch, arcnerf_torch.evaluate, arcnerf_torch.render.engine, arcnerf_torch.utils.model_io\n"
        "import arcnerf_torch.ops.cuda_lib, arcnerf_torch.ops.fused_mlp, arcnerf_torch.render.ray_helper\n"
        "import arcnerf_torch.models.base_modules.encoding, arcnerf_torch.datasets\n"
        "import arcnerf_torch.train, arcnerf_torch.trainer, arcnerf_torch.losses, arcnerf_torch.ops.trunc_exp\n"
        "import arcnerf_torch.ops.gather_scatter, arcnerf_torch.tools.roofline_hashgrid\n"
        "import arcnerf_torch.tools.probe_gather, arcnerf_torch.tools.probe_scatter\n"
        "import arcnerf_torch.tools.probe_cons_forms\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'arcnerf_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
