"""The plain VolSDF: the reference that decides whether a run of the
``volsdf`` configuration is ``correct``.

Plain torch in float32 (TF32 off), written from the paper's equations
(Yariv et al., "Volume Rendering of Neural Implicit Surfaces", arXiv
2106.12052: eq. 2-3, Theorem 1, Lemma 2, Algorithm 1) and ArcNerf's lego
recipe, sharing no code with the program. Its pieces:

- the SDF: the points' sin/cos encoding (6 frequencies and the points, 39
  wide), then 8 hidden layers of 256 with softplus (beta 100), the 4th's
  output 256 - 39 wide and joined by the encoding, the sum over sqrt(2),
  and a 257-wide output (the sdf and 256 features); every layer has a bias
  and its kernel under weight norm (v / |v| per output column, times a
  learned scale);
- the normal: autograd's d sdf / d x with ``create_graph``, so the losses
  differentiate it again (the double backward);
- the radiance: [x, view's encoding (4 frequencies and the unit view), normal,
  feature] (289) -> 256 -> 256 -> 256 -> 256 -> 3, ReLU between, a sigmoid
  at the end, each layer with a bias and weight norm;
- the density: the Laplace CDF of -sdf with scale beta + beta_min, beta =
  exp(10 ln_beta);
- the samples (Algorithm 1): n_eval points evenly in the ray's chord of the
  radius-2 sphere, each jittered in its interval, their sdf evaluated; then
  n_iter rounds, each with Theorem 1's bound d* on each interval, beta from
  Lemma 2's bound (kept from the round before, reset to the model's beta
  where that already meets eps) refined by beta_iter bisections of the
  bound's largest value against eps, and, in each round but the last,
  n_eval new points at evenly spaced u by the inverse CDF of the bound's
  per-interval values, their sdf evaluated and merged in z order; the last
  round draws n_sample points at random u by the inverse CDF of the
  weights; n_importance of the evaluated points join them, one choice for
  every ray;
- the eikonal points: a point in the radius_bound cube a ray, all scaled so
  that the farthest lies on the sphere, and one of the ray's samples;
- compositing over each ray's samples (T_i = prod_{j<i} (1 - alpha_j +
  1e-10), the last interval 1e10 long), white added as 1 - opacity;
- the losses: L1 of the colour, and 0.1 times (|normal| - 1)^2 over the
  eikonal points;
- Adam (betas 0.9, 0.999) at lr 0.1^(t / 500000) times the recipe's rate.

Draws, from one generator in the program's order a step: the ray picks,
the first samples' jitter (n_rays, n_eval), the last round's u (n_rays,
n_sample), the importance keys (n_eval n_iter; the n_importance smallest
pick the points), the surface sample of each ray (n_rays, 1), the cube
point (n_rays, 1, 3).

Departures from the published description (ArcNerf's lego recipe and the
paper), each the configuration's own: Algorithm 1 runs a fixed n_iter
rounds (the paper stops a ray once its bound meets eps); each point's sdf
is evaluated once; the n_importance points are chosen once for all rays;
training images are the benchmark's procedural views over white.

The sampler's decisions (a bisection against eps, a search at a bin under
the inverse CDF's eps) flip on rounding, and a point placed after a flip
has an sdf of its own. So the reference computes in the program's order of
operations and evaluates the sdf in the program's batches (a round's new
points, n_rays n_eval of them; the samples with the eikonal points): where
the arithmetic is the same, the first step's samples come out the same bit
for bit, and the check's sample numbers read the program's faults, not the
sampler's sensitivity.

``Precision``: ``F32`` rounds nothing; ``CONTROL`` is the control of the
correctness check, the GeoNet's matmuls with TF32 operands (each operand's
mantissa rounded to 10 bits, the sums f32), as a card with TF32 on would
run them.
"""

import math
from dataclasses import dataclass

import torch

BETAS = (0.9, 0.999)
WN_EPS = 1e-12


@dataclass(frozen=True)
class Precision:
    geo_tf32: bool = False  # the GeoNet's matmul operands rounded to TF32


F32 = Precision()
CONTROL = Precision(True)


def tf32(x):
    """x with its f32 mantissa rounded to TF32's 10 bits (to nearest, ties
    to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class _TF32(torch.autograd.Function):
    """An operand rounded to TF32 forward, its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _TF32.apply(g)


class Spec:
    """The sizes and constants the reference needs, from a configuration
    file's ``model`` tree."""

    def __init__(self, model):
        geo, rad, rays, params = model["geometry"], model["radiance"], model["rays"], model.get("params", {})
        self.W, self.D, self.skips = int(geo["W"]), int(geo["D"]), tuple(geo["skips"])
        self.n_freqs = int(geo["encoder"]["n_freqs"])
        self.embed = 3 + 6 * self.n_freqs
        self.W_feat = int(geo["W_feat"])
        self.softplus_beta = float(geo["act_cfg"]["beta"])
        self.radius_init = float(geo.get("radius_init", 1.0))
        self.rad_W, self.rad_D = int(rad["W"]), int(rad["D"])
        self.view_freqs = int(rad["encoder"]["view"]["n_freqs"])
        self.rad_in = 3 + (3 + 6 * self.view_freqs) + 3 + int(rad["W_feat_in"])
        self.speed = float(params.get("speed_factor", 10))
        self.beta_min = float(params.get("beta_min", 1e-4))
        self.init_beta = float(params.get("init_beta", 0.1))
        self.radius = float(model["obj_bound"]["sphere"]["radius"])
        self.radius_bound = float(rays["radius_bound"])
        self.n_eval, self.n_iter, self.beta_iter = int(rays["n_eval"]), int(rays["n_iter"]), int(rays["beta_iter"])
        self.eps = float(rays["eps"])
        self.n_sample, self.n_importance = int(rays["n_sample"]), int(rays["n_importance"])

    def geo_dims(self):
        """Each GeoNet layer's (in, out)."""
        dims, d = [], self.embed
        for i in range(self.D + 1):
            out = 1 + self.W_feat if i == self.D else (self.W - self.embed if i in self.skips else self.W)
            dims.append((d, out))
            d = out + (self.embed if i in self.skips and i < self.D else 0)
        return dims

    def rad_dims(self):
        ins = [self.rad_in] + [self.rad_W] * self.rad_D
        outs = [self.rad_W] * self.rad_D + [3]
        return list(zip(ins, outs))

    def leaf_shapes(self):
        shapes = {}
        for net, dims in (("geo", self.geo_dims()), ("rad", self.rad_dims())):
            for i, (a, b) in enumerate(dims):
                shapes["{}.{}".format(net, i)] = (a, b)
                shapes["{}.{}.b".format(net, i)] = (b,)
                shapes["{}.{}.wn".format(net, i)] = (b,)
        shapes["ln_beta"] = (1,)
        return shapes


def encode(x, n_freqs):
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...] with n_freqs powers of 2."""
    parts = [x]
    for i in range(n_freqs):
        parts += [torch.sin(x * 2.0**i), torch.cos(x * 2.0**i)]
    return torch.cat(parts, -1)


def weight_norm(v, scale):
    return v * torch.rsqrt((v * v).sum(0, keepdim=True) + WN_EPS) * scale


def _layer(p, name, h, tf32_ops=False):
    """h @ w + b in one GEMM (the bias in its epilogue)."""
    w = weight_norm(p[name], p[name + ".wn"])
    if tf32_ops:
        h, w = _TF32.apply(h), _TF32.apply(w)
    return torch.addmm(p[name + ".b"], h, w)


def sdf_net(spec, p, x, prec=F32):
    """(N, 3) -> sdf (N,), feature (N, W_feat)."""
    e = encode(x, spec.n_freqs)
    h = e
    for i in range(spec.D + 1):
        h = _layer(p, "geo.{}".format(i), h, prec.geo_tf32)
        if i < spec.D:
            h = torch.nn.functional.softplus(spec.softplus_beta * h) / spec.softplus_beta
            if i in spec.skips:
                h = torch.cat([h, e], -1) / math.sqrt(2.0)
    return h[:, 0], h[:, 1:]


def sdf_normal(spec, p, x, create_graph=True, prec=F32):
    """sdf (N,), feature, normal (N, 3) = d sdf / d x."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        sdf, feat = sdf_net(spec, p, x, prec)
        (normal,) = torch.autograd.grad(sdf.sum(), x, create_graph=create_graph)
    return sdf, feat, normal


def radiance(spec, p, x, dirs, normal, feat):
    view = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    h = torch.cat([x, encode(view, spec.view_freqs), normal, feat], -1)  # the points unencoded (0 frequencies)
    for i in range(spec.rad_D + 1):
        h = _layer(p, "rad.{}".format(i), h)
        if i < spec.rad_D:
            h = torch.relu(h)
    return torch.sigmoid(h)


def beta_of(spec, p):
    return torch.exp(p["ln_beta"] * spec.speed)


def density(spec, sdf, beta):
    """VolSDF eq. 2-3: (1 / b) Psi_b(-sdf), the Laplace CDF of scale b =
    beta + beta_min."""
    b = beta + spec.beta_min
    half = 0.5 * torch.exp(-sdf.abs() / b)
    return (1.0 / b) * torch.where(sdf >= 0, half, 1.0 - half)


def sphere_chord(spec, rays_o, rays_d):
    """Near and far (N, 1) where each ray crosses the sphere."""
    mid = -(rays_o * rays_d).sum(-1, keepdim=True)
    d2 = (rays_o * rays_o).sum(-1, keepdim=True) - mid * mid
    half = torch.sqrt((spec.radius**2 - d2).clamp_min(0.0))
    if bool((d2 > spec.radius**2).any()):
        raise ValueError("a ray misses the sphere: the benchmark's cameras see only the sphere")
    return (mid - half).clamp_min(0.0), (mid + half).clamp_min(0.0)


def first_samples(spec, near, far, u):
    """n_eval points evenly from near to far, each jittered by u within the
    interval between its neighbours' midpoints."""
    t = torch.linspace(0.0, 1.0, spec.n_eval, device=near.device)
    z = near + (far - near) * t
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = torch.cat([z[:, :1], mid], -1)
    hi = torch.cat([mid, z[:, -1:]], -1)
    return lo + (hi - lo) * u


def d_star(z, sdf):
    """Theorem 1: the bound on the distance to the surface inside each
    interval, from its length and the |sdf| at its ends; 0 where the sdf
    changes sign."""
    a = z[:, 1:] - z[:, :-1]
    b, c = sdf[:, :-1].abs(), sdf[:, 1:].abs()
    s = (a + b + c) / 2.0
    height = 2.0 * torch.sqrt((s * (s - a) * (s - b) * (s - c)).clamp_min(0.0)) / (a + 1e-12)
    out = torch.where(b + c - a > 0, height, 0.0)
    out = torch.where(a**2 + c**2 <= b**2, c, out)
    out = torch.where(a**2 + b**2 <= c**2, b, out)
    return torch.where(torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1, out, 0.0)


def interval_bounds(z, sdf, ds, beta, opacity_before):
    """The error bound's value at each interval: (exp(sum of the intervals'
    terms so far) - 1) times exp(-``opacity_before``), the estimated
    opacity integral up to the interval's start (N, n - 1)."""
    a = z[:, 1:] - z[:, :-1]
    terms = torch.exp(-ds / beta) * (a**2) / (4.0 * beta**2)
    return (torch.exp(torch.cumsum(terms, -1)).clamp_max(1e6) - 1.0) * torch.exp(-opacity_before)


def largest_bound(spec, z, sdf, ds, beta):
    a = z[:, 1:] - z[:, :-1]
    sigma = density(spec, sdf, beta)
    before = torch.cumsum(torch.cat([torch.zeros_like(a[:, :1]), a * sigma[:, :-1]], -1), -1)[:, :-1]
    return interval_bounds(z, sdf, ds, beta, before).amax(-1)


def march_weights(sigma, z):
    """The transmittance before each sample and its weight (the last
    interval 1e10 long, intervals under 1e-5 as 0)."""
    delta = z[:, 1:] - z[:, :-1]
    delta = torch.where(delta.abs() < 1e-5, 0.0, delta)
    delta = torch.cat([delta, torch.full_like(z[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-torch.relu(sigma).clamp_max(1e10) * delta)
    trans = torch.exp(torch.cumsum(torch.log((1.0 - alpha + 1e-10).clamp_min(1e-10)), -1))
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    return trans, trans * alpha


def inverse_cdf(z, w, n, u=None, eps=1e-5):
    """n points placed by the inverse CDF of the weights ``w`` over the
    intervals of ``z``; at evenly spaced u in [0, 1] where no u is given."""
    w = w + eps
    cdf = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(w / w.sum(-1, keepdim=True), -1)], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=z.device).expand(z.shape[0], n).contiguous()
    k = torch.searchsorted(cdf, u, right=True)
    lo_i, hi_i = (k - 1).clamp(0, z.shape[1] - 1), k.clamp(0, z.shape[1] - 1)
    c_lo, c_hi = cdf.gather(1, lo_i), cdf.gather(1, hi_i)
    width = torch.where(c_hi - c_lo < eps, 1.0, c_hi - c_lo)
    z_lo, z_hi = z.gather(1, lo_i), z.gather(1, hi_i)
    return torch.sort(z_lo + (u - c_lo) / width * (z_hi - z_lo), -1).values


@torch.no_grad()
def samples(spec, p, rays_o, rays_d, u_first, u_last, keys, prec=F32):
    """Algorithm 1: the (N, n_sample + n_importance) sorted samples of each
    ray."""

    def sdf_at(z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        return sdf_net(spec, p, pts.reshape(-1, 3), prec)[0].reshape(z.shape)

    near, far = sphere_chord(spec, rays_o, rays_d)
    z = first_samples(spec, near, far, u_first)
    beta0 = beta_of(spec, p)[0]
    a = z[:, 1:] - z[:, :-1]
    beta = torch.sqrt((1.0 / (4.0 * math.log(spec.eps + 1.0))) * (a**2).sum(-1))  # Lemma 2
    sdf = sdf_at(z)
    for r in range(spec.n_iter):
        ds = d_star(z, sdf)
        beta = torch.where(largest_bound(spec, z, sdf, ds, beta0) <= spec.eps, beta0, beta)
        lo, hi = torch.full_like(beta, float(beta0)), beta
        for _ in range(spec.beta_iter):
            mid = 0.5 * (lo + hi)
            met = largest_bound(spec, z, sdf, ds, mid[:, None]) <= spec.eps
            lo, hi = torch.where(met, lo, mid), torch.where(met, mid, hi)
        beta = hi
        trans, w = march_weights(density(spec, sdf, beta[:, None]), z)
        if r < spec.n_iter - 1:
            bounds = interval_bounds(z, sdf, ds, beta[:, None], -torch.log(trans.clamp_min(1e-12))[:, :-1])
            new = inverse_cdf(z, bounds, spec.n_eval)
            z, order = torch.sort(torch.cat([z, new], -1), dim=-1, stable=True)
            sdf = torch.cat([sdf, sdf_at(new)], -1).gather(-1, order)
        else:
            drawn = inverse_cdf(z, w[:, :-1], spec.n_sample, u=u_last)
    chosen = z[:, keys.argsort()[:spec.n_importance]]
    return torch.sort(torch.cat([drawn, chosen], -1), -1).values


def render(spec, p, rays_o, rays_d, z, eikonal_pts, prec=F32):
    """Per-ray rgb (N, 3) over white and the eikonal points' normals."""
    n, k = z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    sdf, feat, normal = sdf_normal(spec, p, torch.cat([pts, eikonal_pts]), prec=prec)
    m = n * k
    rgb = radiance(spec, p, pts, rays_d[:, None, :].expand(n, k, 3).reshape(-1, 3), normal[:m], feat[:m])
    sigma = density(spec, sdf[:m].reshape(n, k), beta_of(spec, p))
    _, w = march_weights(sigma, z)
    out = (w[..., None] * rgb.reshape(n, k, 3)).sum(1) + (1.0 - w.sum(1, keepdim=True))
    return out, normal[m:]


def loss_of(rgb, img, normal_eik):
    return (rgb - img).abs().mean() + 0.1 * ((torch.linalg.vector_norm(normal_eik, dim=-1) - 1.0) ** 2).mean()


def step_draws(spec, generator, n_total, n_rays, device):
    """One step's draws in the program's order."""
    pick = torch.randint(0, n_total, (n_rays,), generator=generator, device=device)
    u_first = torch.rand((n_rays, spec.n_eval), generator=generator, device=device)
    u_last = torch.rand((n_rays, spec.n_sample), generator=generator, device=device)
    keys = torch.rand((spec.n_eval * spec.n_iter,), generator=generator, device=device)
    surface = torch.randint(0, spec.n_sample + spec.n_importance, (n_rays, 1), generator=generator, device=device)
    cube = torch.rand((n_rays, 1, 3), generator=generator, device=device)
    return pick, u_first, u_last, keys, surface, cube


def eikonal_points(spec, rays_o, rays_d, z, surface, cube):
    r = spec.radius_bound
    q = cube * (2.0 * r) - r
    q = q / torch.linalg.vector_norm(q, dim=-1).amax().clamp_min(1e-8) * r
    zs = z.gather(1, surface)
    return torch.cat([q, rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]], 1).reshape(-1, 3)


def train_steps(spec, params, pool, generator, n_rays, n_steps, lr, eps, gamma=0.1, decay_steps=500000, prec=F32):
    """``n_steps`` Adam steps from ``params`` (by leaf name) on batches
    drawn as the program draws them. Returns each step's loss, each leaf's
    first gradient, the leaves after the steps and each step's samples."""
    dev = pool["rays_o"].device
    names = list(spec.leaf_shapes())
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, zs = [], None, []
    n_total = pool["rays_o"].shape[0]
    for t in range(1, n_steps + 1):
        pick, u_first, u_last, keys, surface, cube = step_draws(spec, generator, n_total, n_rays, dev)
        o, d, img = pool["rays_o"][pick], pool["rays_d"][pick], pool["img"][pick]
        z = samples(spec, p, o, d, u_first, u_last, keys, prec)
        rgb, normal_eik = render(spec, p, o, d, z, eikonal_points(spec, o, d, z, surface, cube), prec)
        loss = loss_of(rgb, img, normal_eik)
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        zs.append(z)
        rate = lr * gamma ** ((t - 1) / decay_steps)
        with torch.no_grad():
            for k in names:
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g * (1 - BETAS[0]))
                v2[k].mul_(BETAS[1]).add_(g * g * (1 - BETAS[1]))
                denom = (v2[k].sqrt() / math.sqrt(1 - BETAS[1]**t)) + eps
                p[k].sub_(rate / (1 - BETAS[0]**t) * m[k] / denom)
    return losses, first, {k: v.detach() for k, v in p.items()}, zs
