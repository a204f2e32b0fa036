"""Procedural synthetic scene dataset: an analytic sphere scene rendered
by exact ray tracing (counterpart of
``arcnerf_tpu/datasets/synthetic_dataset.py``; needs no download).

A handful of colored lambertian spheres inside the unit volume, viewed from
a camera spiral. Deterministic given ``seed``.
"""

import numpy as np

from ..geometry.poses import generate_cam_pose_on_sphere
from ..render.camera import PerspectiveCamera
from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.registry import DATASET_REGISTRY
from .base import Base3dDataset

# (center xyz, radius, rgb color)
_DEFAULT_SPHERES = [
    ((0.0, 0.15, 0.0), 0.42, (0.85, 0.25, 0.2)),
    ((0.45, -0.25, 0.1), 0.22, (0.2, 0.7, 0.3)),
    ((-0.4, -0.3, -0.15), 0.25, (0.25, 0.35, 0.85)),
    ((0.05, -0.32, -0.45), 0.18, (0.9, 0.8, 0.2)),
]
_LIGHT_DIR = np.array([0.5, -0.8, 0.3])


def trace_sphere_scene(rays_o, rays_d, spheres=None, bkg_color=(1.0, 1.0, 1.0),
                       texture_freq=0.0):
    """Exact-render a sphere scene. rays (N, 3) -> rgb (N, 3), depth (N,),
    mask (N,). Lambertian shading with a fixed directional light.

    ``texture_freq`` > 0 modulates each sphere's albedo with a smooth
    high-frequency 3D sinusoid of the hit point (per-sphere phase) — view-
    consistent surface detail that rewards models resolving fine spatial
    frequencies (the role lego's studs play for the reference benchmarks)
    instead of saturating on flat shading."""
    spheres = spheres or _DEFAULT_SPHERES
    n = rays_o.shape[0]
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)

    best_t = np.full(n, np.inf)
    rgb = np.tile(np.asarray(bkg_color, dtype=np.float32), (n, 1))
    mask = np.zeros(n, dtype=np.float32)

    for si, (center, radius, color) in enumerate(spheres):
        c = np.asarray(center)
        oc = c[None, :] - rays_o
        b = np.sum(oc * rays_d, axis=-1)
        disc = b**2 - (np.sum(oc * oc, axis=-1) - radius**2)
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = b - sq
        t = np.where(t > 1e-3, t, b + sq)
        valid = hit & (t > 1e-3) & (t < best_t)

        pts = rays_o + rays_d * t[:, None]
        normal = (pts - c[None, :]) / radius
        lam = 0.35 + 0.65 * np.maximum(0.0, -np.sum(normal * light[None, :], axis=-1))
        shaded = np.asarray(color)[None, :] * lam[:, None]
        if texture_freq > 0.0:
            f = float(texture_freq)
            ph = 0.7 * si  # decorrelate spheres
            tex = (0.80 + 0.20 * np.sin(f * pts[:, 0] + ph)
                   * np.sin(f * pts[:, 1] + 1.3 + ph) * np.sin(f * pts[:, 2] + 2.1 + ph))
            # a second octave keeps detail at the finest hash levels
            tex = tex * (0.92 + 0.08 * np.sin(2.7 * f * pts[:, 0] + 1.1 + ph)
                         * np.sin(2.7 * f * pts[:, 1] + 0.4 + ph))
            shaded = shaded * tex[:, None]

        rgb = np.where(valid[:, None], shaded, rgb)
        best_t = np.where(valid, t, best_t)
        mask = np.where(valid, 1.0, mask)

    depth = np.where(np.isfinite(best_t), best_t, 0.0)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), depth.astype(np.float32), mask


@DATASET_REGISTRY.register()
class Synthetic(Base3dDataset):
    """Analytic sphere-scene dataset; cfgs: n_imgs, wh (W, H), cam_radius,
    focal_ratio, white_bkg, seed."""

    def __init__(self, cfgs, data_dir=None, mode="train", transforms=None):
        super().__init__(cfgs, data_dir, mode, transforms)
        self.identifier = "synthetic_spheres"
        n_imgs = get_value_from_cfgs_field(cfgs, "n_imgs", 20)
        wh = get_value_from_cfgs_field(cfgs, "wh", [128, 128])
        self.W, self.H = int(wh[0]), int(wh[1])
        cam_radius = get_value_from_cfgs_field(cfgs, "cam_radius", 2.5)
        focal_ratio = get_value_from_cfgs_field(cfgs, "focal_ratio", 1.2)
        white_bkg = get_value_from_cfgs_field(cfgs, "white_bkg", True)
        seed = get_value_from_cfgs_field(cfgs, "seed", 42)
        bkg = (1.0, 1.0, 1.0) if white_bkg else (0.0, 0.0, 0.0)

        # spiral poses cover elevation; mode-dependent offset decorrelates
        # train/val/eval viewpoints
        u_start = {"train": 0.0, "val": 0.37, "eval": 0.71}.get(mode, 0.0)
        c2ws = generate_cam_pose_on_sphere(
            "spiral", cam_radius, n_imgs, u_start=u_start, v_range=(-0.6, 0.3), n_rot=3,
            rng=np.random.default_rng(seed),
        )

        intrinsic = np.eye(3)
        intrinsic[0, 0] = intrinsic[1, 1] = focal_ratio * self.W
        intrinsic[0, 2] = self.W / 2.0
        intrinsic[1, 2] = self.H / 2.0

        self.cameras = [PerspectiveCamera(intrinsic, c2ws[i], self.W, self.H) for i in range(n_imgs)]
        self.n_imgs = n_imgs

        # supersample > 1: trace an ss x ss subpixel grid and box-average.
        # The default 1-sample GT has hard aliased silhouettes no volumetric
        # render can reproduce exactly — at 400x400 that alone caps
        # achievable PSNR around ~34 dB (the r4 ladder ceiling); ss=4 GT is
        # the scene's antialiased "ground truth render", the role the
        # blender-rendered lego images play for the reference ladder.
        ss = int(get_value_from_cfgs_field(cfgs, "supersample", 1))
        texture_freq = float(get_value_from_cfgs_field(cfgs, "texture_freq", 0.0))
        self.images, self.masks = [], []
        for i in range(n_imgs):
            if ss > 1:
                intr_ss = intrinsic.copy()
                intr_ss[:2] *= ss
                cam_ss = PerspectiveCamera(intr_ss, c2ws[i], self.W * ss, self.H * ss)
                ro, rd, _, _ = cam_ss.get_rays(wh_order=False, center_pixel=self.center_pixel)
                ro, rd = ro.numpy(), rd.numpy()
                rgb, _, mask = trace_sphere_scene(
                    ro, rd, bkg_color=bkg, texture_freq=texture_freq)
                rgb = rgb.reshape(self.H, ss, self.W, ss, 3).mean(axis=(1, 3))
                mask = mask.reshape(self.H, ss, self.W, ss).mean(axis=(1, 3))
                self.images.append(rgb.astype(np.float32))
                self.masks.append(mask.astype(np.float32))
            else:
                cam = self.cameras[i]
                ro, rd, _, _ = cam.get_rays(wh_order=False, center_pixel=self.center_pixel)
                ro, rd = ro.numpy(), rd.numpy()
                rgb, _, mask = trace_sphere_scene(
                    ro, rd, bkg_color=bkg, texture_freq=texture_freq)
                self.images.append(rgb.reshape(self.H, self.W, 3))
                self.masks.append(mask.reshape(self.H, self.W))

        self.skip_samples()
        self.keep_eval_samples()
        if get_value_from_cfgs_field(cfgs, "precache", False):
            self.precache_ray()


def sphere_scene_bitfield(n_grid, side=2.0, spheres=None):
    """(n_grid,)*3 bool occupancy of a centered cube of ``side``: voxels
    whose center lies inside a sphere of the scene grown by half a voxel
    diagonal - the bitfield a trained occupancy grid converges to."""
    spheres = spheres or _DEFAULT_SPHERES
    vs = side / n_grid
    axis = (np.arange(n_grid) + 0.5) * vs - side / 2.0
    pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)
    occ = np.zeros((n_grid,) * 3, dtype=bool)
    for center, radius, _ in spheres:
        occ |= np.linalg.norm(pts - np.asarray(center), axis=-1) <= radius + 0.5 * np.sqrt(3.0) * vs
    return occ
