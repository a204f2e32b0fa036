"""VolSDF: the sdf to a density through the Laplace CDF with a learned beta
(Yariv et al., arXiv 2106.12052, eq. 2-3), sampled by Algorithm 1's error
bound.

Counterpart of ``arcnerf_tpu/models/volsdf_model.py`` (``sdf_to_sigma``,
``VolSDF``: ``get_d_star``, ``get_integral_bound``, ``get_error_bound``,
``upsample_zvals``, ``get_eikonal_pts``, ``_forward``). The bound gives each ray its first ``n_eval``
samples (``FgModel``'s grid path: a ``SphereBound``'s near and far,
jittered in training); ``n_iter`` fixed rounds of Algorithm 1 follow, each
with the Theorem-1 bound ``d_star``, beta started at Lemma 2's bound and
refined by ``beta_iter`` bisections, and every round but the last adding
``n_eval`` points by the bound's inverse CDF (deterministic u); the last
round draws ``n_sample`` points by the weights, and ``n_importance`` of
the evaluated points join them (one draw for all rays). The geometry chain
(``geo_with_grad``: ``GeoNet``'s sdf, feature and normal, with
``create_graph`` in training) runs once over the samples and the eikonal
points (one random point in the radius_bound sphere and one sample a ray);
the radiance net reads the samples' normals, so the loss differentiates the
chain twice. The samples composite as a stream of fixed segments
(``segment_march``: kernels C and F in their sigma mode with add_inf_z).
No step reads the host, so ``StepGraph`` captures it whole.

Departures from the JAX package: the sampler evaluates each new point's
sdf once and carries it through the merge-sort (the JAX rounds re-evaluate
every point, the same numbers at three times the work); the eikonal points
take no radiance (the JAX package evaluates it and drops it); and the
radiance net encodes its view as the config says (``RadianceNet``; the JAX
net drops its encoders, ROADMAP Queue 3). The surface render and the
occupancy estimate (``get_est_opacity``: the sphere bound keeps no
occupancy) are not ported.
"""

import math

import torch

from ..geometry.transformation import normalize
from ..render.ray_helper import march_group, ray_marching, sample_pdf, segment_march
from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.device_consts import device_constant
from ..utils.registry import MODEL_REGISTRY
from .base_modules import build_geo_model, build_radiance_model
from .sdf_model import SdfModel, geo_with_grad


def sdf_to_sigma(sdf, beta, beta_min=1e-4):
    """The Laplace-CDF density of the sdf (VolSDF eq. 2-3) with scale beta +
    beta_min."""
    beta = beta + beta_min
    alpha = 1.0 / beta
    exp = 0.5 * torch.exp(-sdf.abs() / beta)
    return alpha * torch.where(sdf >= 0, exp, 1.0 - exp)


def get_d_star(dists, sdf):
    """Theorem 1's distance bound on each interval of (B, N) samples whose
    lengths are ``dists`` (B, N - 1): 0 where the sdf changes sign."""
    a, b, c = dists, sdf[:, :-1].abs(), sdf[:, 1:].abs()
    first = a**2 + b**2 <= c**2
    second = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area2 = (s * (s - a) * (s - b) * (s - c)).clamp_min(0.0)
    h = 2.0 * torch.sqrt(area2) / (a + 1e-12)
    d_star = torch.where(first, b, torch.where(second, c, torch.where(b + c - a > 0, h, 0.0)))
    same_sign = torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1
    return torch.where(same_sign, d_star, 0.0)


def get_integral_bound(integral_esti, beta, d_star, dists):
    """The bound on the opacity's error at each interval, given the
    estimated integral (B, N) up to each sample."""
    err = torch.exp(-d_star / beta) * (dists**2) / (4.0 * beta**2)
    err_int = torch.cumsum(err, -1)
    return (torch.exp(err_int).clamp_max(1e6) - 1.0) * torch.exp(-integral_esti[:, :-1])


def get_error_bound(beta, sdf, dists, d_star, beta_min=1e-4):
    """Each ray's largest bound (B,) at scale ``beta``."""
    sigma = sdf_to_sigma(sdf, beta, beta_min)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]), dists * sigma[:, :-1]], -1)
    integral_esti = torch.cumsum(shifted, -1)
    return get_integral_bound(integral_esti, beta, d_star, dists).amax(-1)


@MODEL_REGISTRY.register()
class VolSDF(SdfModel):

    def __init__(self, cfgs, generator=None):
        super().__init__(cfgs)
        params = get_value_from_cfgs_field(cfgs.model, "params", None)
        rays = cfgs.model.rays
        self.speed_factor = float(get_value_from_cfgs_field(params, "speed_factor", 10))
        self.beta_min = float(get_value_from_cfgs_field(params, "beta_min", 1e-4))
        init_beta = float(get_value_from_cfgs_field(params, "init_beta", 0.1))
        self.radius_bound = float(get_value_from_cfgs_field(rays, "radius_bound", 1.5))
        self.n_eval = int(get_value_from_cfgs_field(rays, "n_eval", 128))
        self.n_iter = int(get_value_from_cfgs_field(rays, "n_iter", 5))
        self.beta_iter = int(get_value_from_cfgs_field(rays, "beta_iter", 10))
        self.eps = float(get_value_from_cfgs_field(rays, "eps", 0.1))
        self.geo_net = build_geo_model(cfgs.model.geometry, generator)
        self.radiance_net = build_radiance_model(cfgs.model.radiance, generator)
        self.ln_beta = torch.nn.Parameter(torch.tensor([math.log(init_beta) / self.speed_factor]))

    def get_net(self):
        return self.geo_net, self.radiance_net

    def forward_beta(self):
        return torch.exp(self.ln_beta * self.speed_factor)

    def get_n_coarse_sample(self):
        return self.n_eval

    def n_samples(self):
        """The samples a ray composites: n_sample drawn, n_importance kept."""
        return self.get_ray_cfgs("n_sample") + self.get_ray_cfgs("n_importance")

    # ------------------------------------------------------------ sampling
    def _sdf_of(self, rays_o, rays_d, zvals):
        """The sdf (B, k) at ``zvals`` (B, k) along the rays, no gradient."""
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * zvals[..., None]).reshape(-1, 3)
        return self.geo_net(pts)[0].reshape(zvals.shape)

    @torch.no_grad()
    def upsample_zvals(self, rays_o, rays_d, zvals, inference_only=True, generator=None):
        """Algorithm 1 from the first ``n_eval`` samples (B, n_eval) ->
        the sorted samples (B, n_sample + n_importance) and each ray's
        surface sample (B, 1) for the eikonal loss. Training draws (from
        ``generator``, in this order): the last round's u (B, n_sample), the
        n_importance evaluated points (one draw for all rays), the surface
        sample's index (B, 1)."""
        n_rays = zvals.shape[0]
        n_sample, n_importance = self.get_ray_cfgs("n_sample"), self.get_ray_cfgs("n_importance")
        draw = generator if not inference_only else None
        beta0 = self.forward_beta()
        dists = zvals[:, 1:] - zvals[:, :-1]
        beta = torch.sqrt((1.0 / (4.0 * math.log(self.eps + 1.0))) * (dists**2).sum(-1))  # Lemma 2
        sdf = self._sdf_of(rays_o, rays_d, zvals)
        for it in range(self.n_iter):
            dists = zvals[:, 1:] - zvals[:, :-1]
            d_star = get_d_star(dists, sdf)
            cur_error = get_error_bound(beta0, sdf, dists, d_star, self.beta_min)
            beta = torch.where(cur_error <= self.eps, beta0, beta)
            lo, hi = beta0.expand(n_rays), beta
            for _ in range(self.beta_iter):
                mid = 0.5 * (lo + hi)
                err = get_error_bound(mid[:, None], sdf, dists, d_star, self.beta_min)
                hi = torch.where(err <= self.eps, mid, hi)
                lo = torch.where(err > self.eps, mid, lo)
            beta = hi
            march = ray_marching(sdf_to_sigma(sdf, beta[:, None], self.beta_min), None, zvals, add_inf_z=True)
            if it < self.n_iter - 1:
                pdf = get_integral_bound(-torch.log(march["trans_shift"].clamp_min(1e-12)), beta[:, None], d_star,
                                         dists)
                new = sample_pdf(zvals, pdf, self.n_eval, det=True)
                zvals, order = torch.sort(torch.cat([zvals, new], -1), dim=-1, stable=True)
                sdf = torch.cat([sdf, self._sdf_of(rays_o, rays_d, new)], -1).gather(-1, order)
            else:
                det = draw is None or not self.get_ray_cfgs("perturb")
                samples = sample_pdf(zvals, march["weights"][:, :-1], n_sample, det=det, generator=draw)
        if n_importance > 0:
            n_total = zvals.shape[1]
            if draw is None:
                picks = torch.linspace(0, n_total - 1, n_importance, dtype=torch.float64).long().tolist()
                sel = device_constant(picks, torch.int64, zvals.device)
            else:
                sel = torch.rand((n_total,), generator=draw, device=zvals.device).argsort()[:n_importance]
            samples = torch.sort(torch.cat([samples, zvals[:, sel]], -1), -1).values
        if draw is not None:
            idx = torch.randint(0, samples.shape[1], (n_rays, 1), generator=draw, device=zvals.device)
        else:
            idx = torch.full((n_rays, 1), samples.shape[1] // 2, dtype=torch.int64, device=zvals.device)
        return samples, samples.gather(1, idx)

    def get_eikonal_pts(self, rays_o, rays_d, zvals_surface, generator=None):
        """One point a ray uniform in the radius_bound cube, all scaled so the
        farthest lies on the sphere, and the ray's surface sample: (B, 2, 3)."""
        n_rays, r = rays_o.shape[0], self.radius_bound
        if generator is not None:
            pts_rand = torch.rand((n_rays, 1, 3), generator=generator, device=rays_o.device) * (2.0 * r) - r
        else:
            pts_rand = torch.zeros((n_rays, 1, 3), device=rays_o.device)
        norm_max = torch.linalg.vector_norm(pts_rand, dim=-1).amax().clamp_min(1e-8)
        pts_rand = pts_rand / norm_max * r
        pts_surface = rays_o[:, None, :] + rays_d[:, None, :] * zvals_surface[..., None]
        return torch.cat([pts_rand, pts_surface], 1)

    # ------------------------------------------------------------- forward
    def _forward(self, inputs, inference_only=True, get_progress=False, generator=None):
        rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
        n_rays = rays_o.shape[0]
        with profiler.span("model.sample"), profiler.span("model.error_bound", iters=self.n_iter):
            zvals, zvals_surface = self.upsample_zvals(rays_o, rays_d, inputs["zvals"], inference_only, generator)
        n_pts = zvals.shape[1]
        k = n_rays * n_pts
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * zvals[..., None]).reshape(-1, 3)
        dirs = rays_d[:, None, :].expand(n_rays, n_pts, 3).reshape(-1, 3)
        if not inference_only:
            eikonal = self.get_eikonal_pts(rays_o, rays_d, zvals_surface, generator).reshape(-1, 3)
            pts_geo = torch.cat([pts, eikonal])
        else:
            pts_geo = pts
        sdf, feat, normal = geo_with_grad(self.geo_net, pts_geo, create_graph=not inference_only)
        with profiler.span("model.field"):
            radiance = self.radiance_net(pts, dirs, normal[:k], feat[:k])
        with profiler.span("model.sdf_density"):
            sigma = sdf_to_sigma(sdf[:k, 0], self.forward_beta(), self.beta_min)
        off = torch.arange(n_rays, device=zvals.device) * n_pts
        cnt = torch.full((n_rays,), n_pts, dtype=torch.int64, device=zvals.device)
        z = zvals.reshape(-1)
        with profiler.span("model.march"):
            out = segment_march(sigma, radiance, z, off, cnt, add_inf_z=self.get_ray_cfgs("add_inf_z"),
                                white_bkg=self.get_ray_cfgs("white_bkg"), bkg_color=inputs.get("bkg_color"),
                                group=march_group())
            out.pop("trans_end")
            if inference_only:
                # the weights' sum of the unit normals: the same march with the normals as colours
                unit = segment_march(sigma, normalize(normal), z, off, cnt, add_inf_z=self.get_ray_cfgs("add_inf_z"),
                                     group=march_group())
                out["normal"] = unit["rgb"]
        if inference_only:
            if profiler.active():  # training counts its steps outside the captured step
                self.count_step_work(n_rays, 1, eikonal=False)
        else:
            out["normal_pts"] = normal[k:].reshape(n_rays, -1, 3)
            out["params"] = {"beta": self.forward_beta()[0]}
        return out

    def count_step_work(self, n_rays, steps, eikonal=True):
        """``volsdf.eval_pts``: the sampler's sdf evaluations, n_eval a ray
        and round; ``sdf.normal_pts``: the samples (and in training the two
        eikonal points a ray) whose normals a call takes."""
        profiler.count("volsdf.eval_pts", n_rays * self.n_eval * self.n_iter * steps)
        self.count_normal_pts(n_rays * (self.n_samples() + (2 if eikonal else 0)) * steps)
