"""Traffic made from ``--seed`` and a workload file's parameters: the
training views, the serving orbit, the served model's weights. Every seed
gets the same sizes; the seed turns the cameras by less than one step of
their track, draws the weights, and seeds the program's own draws.
"""

import hashlib
import math

import torch

from . import scene
from .reference.ngp import LEAVES


def derived_seed(seed, what):
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(hashlib.sha256("{}:{}".format(seed, what).encode()).hexdigest()[:15], 16)


def fraction(seed, what):
    return derived_seed(seed, what) / float(1 << 60)


def training_views(p, seed, device):
    """``p``: n_views, wh, cam_radius, v_range, n_rot. The views of a spiral
    of ``n_rot`` turns from polar angle v_range[0] to v_range[1] (in units
    of pi / 2 from the equator, as the recipe's dataset gives them), traced
    exactly over a white background: a list of per-view dicts of numpy
    arrays (img, mask, rays_o, rays_d), and one held-out view off the
    spiral (a dict of device tensors)."""
    n, (w, h) = int(p["n_views"]), p["wh"]
    n_per = math.ceil(n / p["n_rot"])
    k = torch.arange(n, dtype=torch.float64, device=device)
    u = ((k % n_per) / n_per + fraction(seed, "views") / n_per) % 1.0 * 2 * math.pi
    v = (1.0 - (p["v_range"][0] + (p["v_range"][1] - p["v_range"][0]) * k / max(n - 1, 1))) * math.pi / 2
    poses = scene.look_at(scene.sphere_point(u, v, p["cam_radius"]))
    views = []
    for c2w in poses:
        o, d = scene.camera_rays(c2w, w, h)
        rgb, mask = scene.trace(o, d)
        views.append({"img": rgb.cpu().numpy(), "mask": mask.cpu().numpy(), "rays_o": o.cpu().numpy(),
                      "rays_d": d.cpu().numpy()})
    held = scene.look_at(scene.sphere_point(torch.tensor([0.37 * 2 * math.pi], dtype=torch.float64, device=device),
                                            torch.tensor([0.45 * math.pi], dtype=torch.float64, device=device),
                                            p["cam_radius"]))[0]
    o, d = scene.camera_rays(held, w, h)
    rgb, _ = scene.trace(o, d)
    return views, {"rays_o": o, "rays_d": d, "img": rgb, "H": h, "W": w}


def orbit(p, seed, device):
    """``p``: n_poses, wh, cam_radius, v_ratio. A circle of n_poses cameras
    at polar angle (1 - v_ratio) pi / 2, turned by a fraction of a step
    from the seed: (n_poses, 3, 4) camera-to-world on ``device``."""
    n = int(p["n_poses"])
    u = (torch.arange(n, dtype=torch.float64, device=device) + fraction(seed, "orbit")) / n * 2 * math.pi
    v = torch.full_like(u, (1.0 - p["v_ratio"]) * math.pi / 2)
    return scene.look_at(scene.sphere_point(u, v, p["cam_radius"]))


def leaf_shapes(model):
    """Each leaf's shape from a configuration's model tree."""
    enc, geo, rad = model["geometry"]["encoder"], model["geometry"], model["radiance"]
    n_in = enc["n_levels"] * enc["n_feat_per_entry"]
    n_geo = 1 + geo["W_feat"]
    n_rad = 3 + rad["W_feat_in"]
    return {"table": (enc["n_levels"], 1 << enc["hashmap_size"], enc["n_feat_per_entry"]),
            "geo.0": (n_in, geo["W"]), "geo.out": (geo["W"], n_geo),
            "rad.0": (n_rad, rad["W"]), "rad.1": (rad["W"], rad["W"]), "rad.out": (rad["W"], 3)}


def weights(model, p, seed, device):
    """``p``: table_range, and for a served model scene_level and
    scene_gain. The leaves by name, made on ``device`` from the seed in two
    calls: the table uniform in +-table_range, the MLP weights normal
    clamped at 2 std over sqrt(fan-in) / 0.88 (the recipe's init). With
    ``scene_gain`` the model is also given the scene's surfaces: feature 0
    of the dense level ``scene_level`` holds a signed distance to the
    spheres, clamped to [-1, 1], and two hidden units carry it alone to the
    density, exp(gain * s): opaque inside, clear outside."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "weights"))
    shapes = leaf_shapes(model)
    r = float(p["table_range"])
    out = {"table": (torch.rand(shapes["table"], generator=gen, device=device) * 2 - 1) * r}
    mats = [k for k in LEAVES if k != "table"]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in mats), generator=gen, device=device).clamp_(-2.0, 2.0)
    for k, part in zip(mats, torch.split(flat, [math.prod(shapes[k]) for k in mats])):
        out[k] = part.reshape(shapes[k]) * (0.8796256610342398 * math.sqrt(shapes[k][0])) ** -1
    if p.get("scene_gain"):
        give_surfaces(model, out, int(p["scene_level"]), float(p["scene_gain"]))
    return out


def give_surfaces(model, leaves, level, gain):
    from .reference.ngp import Spec

    spec = Spec(model)
    res = spec.res[level]
    n1 = res + 1
    if n1**3 > spec.table_size:
        raise ValueError("level {} is hashed: the scene needs a dense level".format(level))
    dev = leaves["table"].device
    axis = torch.arange(n1, dtype=torch.float64, device=dev) * spec.side / res - spec.side / 2.0
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
    width = 2.0 * spec.side / res
    signed = torch.full(pts.shape[:-1], -1.0, dtype=torch.float64, device=dev)
    for centre, radius, _ in scene.SPHERES:
        dist = torch.linalg.vector_norm(pts - torch.tensor(centre, dtype=torch.float64, device=dev), dim=-1)
        signed = torch.maximum(signed, ((radius - dist) / width).clamp(-1.0, 1.0))
    leaves["table"][level, :n1**3, 0] = signed.reshape(-1).float()
    i = level * spec.n_feat
    leaves["geo.0"][:, :2] = 0.0
    leaves["geo.0"][i, 0], leaves["geo.0"][i, 1] = 1.0, -1.0
    leaves["geo.out"][:, 0] = 0.0
    leaves["geo.out"][0, 0], leaves["geo.out"][1, 0] = gain, -gain
