"""The plain reference against the program's plain path (its kernels'
CPU versions) at a tiny size: the hash grid under both hashes, the sampler
with its jitter and occupancy, the occupancy update, and a whole capped
render."""

import pytest
import torch

from bench_torch import port, run, scene, traffic
from bench_torch.reference import ngp


def tiny(name):
    _, _, config, workload = run.load_cell(name, rehearse=True)
    return config["run"], workload


@pytest.mark.parametrize("cell", ["train_ngp_quad", "train_ngp_xor"])
def test_hash_grid_matches_the_program(cell):
    from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode_reference

    tree, _ = tiny(cell)
    spec = ngp.Spec(tree["model"])
    enc_cfg = tree["model"]["geometry"]["encoder"]
    enc = HashGridEmbedder(n_levels=enc_cfg["n_levels"], n_feat_per_entry=2, hashmap_size=enc_cfg["hashmap_size"],
                           side=2.0, include_input=False, quad_hash=enc_cfg.get("quad_hash", True),
                           pair_hash=enc_cfg.get("pair_hash", True))
    assert enc.variant == spec.variant and enc.resolutions == spec.res
    gen = torch.Generator().manual_seed(3)
    table = torch.rand((spec.n_levels, spec.table_size, 2), generator=gen) * 2 - 1
    xyz = torch.rand((5000, 3), generator=gen) * 2 - 1
    ours = ngp.hash_features(spec, xyz, table)
    theirs = hash_encode_reference(xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, enc.variant, False)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-6)


def test_sampler_matches_the_program():
    from arcnerf_torch.geometry.volume import Volume
    from arcnerf_torch.models.base_modules.obj_bound import _occ_mask_soa
    from arcnerf_torch.render.ray_helper import get_zvals_from_near_far_fix_step

    tree, _ = tiny("train_ngp_quad")
    spec = ngp.Spec(tree["model"])
    c2w = traffic.orbit({"n_poses": 3, "cam_radius": 2.5, "v_ratio": 0.2}, 1, "cpu")[1]
    o, d = scene.camera_rays(c2w, 40, 40)
    bits = scene.bitfield(spec.n_grid, spec.side)
    u = torch.rand((o.shape[0], spec.n_sample), generator=torch.Generator().manual_seed(1))
    z, valid, _ = ngp.samples(spec, bits, o, d, u)
    vol = Volume(n_grid=spec.n_grid, side=spec.side)
    near, far, _, hit = vol.ray_volume_intersection(o, d)
    z_p, mask_p = get_zvals_from_near_far_fix_step(near, far, vol.get_diag_len() / spec.n_sample, spec.n_sample,
                                                   rand=u)
    mask_p = mask_p & _occ_mask_soa(vol, bits, o, d, z_p) & hit
    assert torch.equal(valid, mask_p)
    torch.testing.assert_close(z[valid], z_p[valid], rtol=0, atol=0)


@pytest.mark.parametrize("table_range", [1e-4, 1.0])
def test_capped_render_matches_the_program(table_range):
    tree, _ = tiny("serve_exact_ngp_quad")
    spec = ngp.Spec(tree["model"])
    leaves = traffic.weights(tree["model"], {"table_range": table_range}, 7, "cpu")
    bits = scene.bitfield(spec.n_grid, spec.side)
    engine = port.engine(tree, torch.device("cpu"), leaves, bits)
    engine.set_render_cap(16)
    c2w = traffic.orbit({"n_poses": 5, "cam_radius": 2.5, "v_ratio": 0.2}, 7, "cpu")[2]
    o, d = scene.camera_rays(c2w, 48, 48)
    white = torch.ones(3)
    out = engine.render_image({"rays_o": o, "rays_d": d, "H": 48, "W": 48}, bkg_color=white)
    rgb, depth, _ = ngp.render_frame(spec, leaves, bits, o, d, white, cap=16)
    # the program's MLPs round to bf16: a few thousandths at most
    err = (out["rgb"].reshape(-1, 3) - rgb).abs()
    assert float(err.max()) < 2e-2 and float(err.mean()) < 1e-3
    assert float((out["depth"].reshape(-1) - depth).abs().mean()) < 1e-2


def test_occupancy_update_matches_the_program():
    from arcnerf_torch.models import build_model

    tree, _ = tiny("train_ngp_quad")
    spec = ngp.Spec(tree["model"])
    leaves = traffic.weights(tree["model"], {"table_range": 1.0}, 5, "cpu")
    model = build_model(port.cfgs(tree, "cpu"), generator=torch.Generator().manual_seed(0))
    port.load_leaves(model, leaves)
    bits = scene.bitfield(spec.n_grid, spec.side)
    opa = bits.to(torch.float32) * 0.5
    bound = model.fg_model.get_obj_bound()
    new = bound.optimize({"bitfield": bits.clone(), "opafield": opa.clone()}, 10**9, spec.n_sample,
                         lambda dt, pts: model.get_est_opacity(dt, pts).detach(),
                         generator=torch.Generator().manual_seed(9))
    ref_opa, ref_bits = ngp.occupancy_update(spec, leaves, opa, bits, torch.Generator().manual_seed(9))
    # the program's MLPs round to bf16
    torch.testing.assert_close(new["opafield"], ref_opa, rtol=2e-2, atol=1e-6)
    assert int((new["bitfield"] != ref_bits).sum()) <= 2 and not torch.equal(ref_bits, bits)
