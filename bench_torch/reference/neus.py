"""The plain NeuS-NGP: the reference that decides whether a run of the
``neus_ngp`` configuration is ``correct``.

Plain torch in float32 (TF32 off), written from the recipe's equations and
sharing no code with the program: NeuS (Wang et al., arXiv 2106.10689, eq.
13) with an Instant-NGP hash grid (the hash helpers of ``reference/ngp.py``)
feeding the geometry MLP. Its pieces:

- the SDF: the hash grid (32 features), then 32 -> 64 -> 17 without bias,
  softplus with beta 100 between, each layer's kernel under weight norm
  (v / |v| per output column, times a learned scale); output 0 is the sdf,
  1-16 the feature;
- the normal: autograd's d sdf / d x with ``create_graph``, so the losses
  differentiate it again (the double backward);
- the radiance: [x, view, normal, feature] (25) -> 64 -> 64 -> 3 without
  bias, ReLU between, a sigmoid at the end;
- the samples: the fix-step ladder of ``reference/ngp.py`` with its
  jitter and occupancy, made dense; each ray's valid samples moved to the
  front of its row in ladder order (left-compacted), and NeuS's sections on
  them: c valid samples give c + 1 sections (at most n_sample; none for a
  ray with no sample), section j < c - 1 between samples j and j + 1,
  section c - 1 from the last sample to last + 2 sd with sd = (last -
  first) / n_sample / 2, section c of length 0 there; the point budget
  keeps the first ``budget`` sections in ray-major order;
- alpha: with the scale exp(10 inv_s) and the slope annealed by
  cos_anneal = epoch / anneal_end, the sdf extended half a length back and
  forth along the slope, alpha = (cdf(prev) - cdf(next) + 1e-5) /
  (cdf(prev) + 1e-5), cdf = sigmoid(scale sdf), clipped to [0, 1];
- compositing over each ray's kept sections (T_i = prod_{j<i} (1 - alpha_j
  + 1e-10)), the background added with the last T; rays with no sample
  take the background, depth_far and opacity 0;
- the losses: Huber (delta 0.1) of the colour over the rays the ground
  truth's mask covers, times 5; the BCE of the opacity against the mask,
  times 0.1; (|normal| - 1)^2 over the kept sections, times 0.1;
- AdamW (the decay decoupled: p <- p (1 - lr wd), then Adam) and the EMA
  of the parameters (0.95);
- the occupancy update of ``reference/ngp.py``'s draws (a quarter of the
  voxels uniform without replacement, a quarter from the occupied ones,
  a jitter in each, each point placed in the program's rounding steps),
  each voxel's opacity NeuS's estimate: alpha over a
  section of length dt / sqrt(3) along -x, from the sdf and the
  first-order normal, with the slope's positive part cut.

Departures from the published description (ArcNerf's lego recipe and the
NeuS paper), each the configuration's or the program's own: the view
direction enters the radiance net unencoded (the recipe names SH degree
4); the hash is the quad hash; NeuS's sections are those of the program's
stream (a ray has none without a sample, no padding sections are
composited, the budget ends a ray's sections); the eikonal mean weighs each
kept section once; the decay is AdamW's (ArcNerf's Adam adds wd p to the
gradient).

``Precision`` sets what the reference rounds to: ``F32`` rounds nothing;
``STATED`` rounds where the configuration states it (the table's reads
and the radiance MLP's operands to bf16; the geometry chain, its
derivatives, alpha, compositing and the losses stay f32), and is the
reference the check compares with: the normal is a difference of
neighbouring table entries, so a program that reads the table in bf16, as
the configuration says, moves its normals, and through the eikonal loss
its third step, away from an f32-read reference by the reads' rounding
alone; ``CONTROL`` is the control of the correctness check, every
precision the configuration states stepped down once (the table's reads
from bf16 to fp8 e4m3, the radiance MLP's operands from bf16 to fp8 e4m3,
the geometry chain and its derivatives from f32 to bf16).
"""

import math
from dataclasses import dataclass

import torch

from .ngp import BETAS, _round, box_near_far, corners, keep_budget, ladder, occupied

LEAVES = ("table", "geo.0", "geo.0.wn", "geo.out", "geo.out.wn", "rad.0", "rad.1", "rad.out", "inv_s")
WN_EPS = 1e-12


@dataclass(frozen=True)
class Precision:
    table: torch.dtype = None  # rounding of the table's reads
    geo: torch.dtype = None  # the geometry chain's operands and its derivatives' (through autograd)
    rad: torch.dtype = None  # the radiance MLP's operands (f32 accumulation)


F32 = Precision()
STATED = Precision(torch.bfloat16, None, torch.bfloat16)
CONTROL = Precision(torch.float8_e4m3fn, torch.bfloat16, torch.float8_e4m3fn)


class _RoundBoth(torch.autograd.Function):
    """x rounded to ``dtype`` forward, and its gradient rounded too: a chain
    computed in ``dtype``, its derivatives included."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _RoundBoth.apply(g, ctx.dtype), None


def _round_both(x, dtype):
    return x if dtype is None else _RoundBoth.apply(x, dtype)


class Spec:
    """The sizes and constants the reference needs, from a configuration
    file's ``model`` tree."""

    def __init__(self, model):
        from .ngp import Spec as NgpSpec

        self.ngp = NgpSpec(model)
        params = model.get("params", {})
        self.speed = float(params.get("speed_factor", 10))
        self.anneal_end = float(params.get("anneal_end", 0))
        self.init_var = float(params.get("init_var", 0.05))
        self.beta = float(model["geometry"]["act_cfg"]["beta"])
        self.w_feat = int(model["geometry"]["W_feat"])

    def __getattr__(self, name):
        return getattr(self.ngp, name)


def hash_features(spec, xyz, table, prec=F32):
    """(N, 3) -> (N, L F) trilinear features; differentiable in xyz (the
    weights) and in the table."""
    flat = _round(table, prec.table).reshape(-1, spec.n_feat)
    out = 0.0
    for entry, w in corners(spec.ngp, xyz):
        out = out + flat[entry] * w[..., None]
    return out.reshape(xyz.shape[0], spec.n_levels * spec.n_feat)


def weight_norm(v, scale):
    return v * torch.rsqrt((v * v).sum(0, keepdim=True) + WN_EPS) * scale


def sdf_net(spec, params, xyz, prec=F32):
    """(N, 3) -> sdf (N,), feature (N, W_feat)."""
    h = _round_both(hash_features(spec, xyz, params["table"], prec), prec.geo)
    h = h @ _round_both(weight_norm(params["geo.0"], params["geo.0.wn"]), prec.geo)
    y = spec.beta * h  # softplus(y) = log(1 + e^y), written so that its second derivative never overflows
    h = (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) / spec.beta
    h = _round_both(h, prec.geo)
    out = h @ _round_both(weight_norm(params["geo.out"], params["geo.out.wn"]), prec.geo)
    out = _round_both(out, prec.geo)
    return out[:, 0], out[:, 1:1 + spec.w_feat]


def sdf_normal(spec, params, xyz, create_graph=True, prec=F32):
    """sdf (N,), feature, normal (N, 3) = d sdf / d xyz."""
    with torch.enable_grad():
        x = xyz.detach().requires_grad_(True)
        sdf, feat = sdf_net(spec, params, x, prec)
        (normal,) = torch.autograd.grad(sdf.sum(), x, create_graph=create_graph)
    return sdf, feat, normal


def radiance(params, xyz, dirs, normal, feat, prec=F32):
    view = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    h = torch.cat([xyz, view, normal, feat], -1)
    ws = [params["rad.0"], params["rad.1"], params["rad.out"]]
    for i, w in enumerate(ws):
        h = _round(h, prec.rad) @ _round(w, prec.rad)
        if i < len(ws) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def scale(spec, params):
    return torch.exp(params["inv_s"] * spec.speed)


def alpha_of(sdf, dist, slope, s):
    """NeuS eq. 13 over a section of length ``dist``."""
    prev_sdf = sdf - slope * dist * 0.5
    next_sdf = sdf + slope * dist * 0.5
    prev_cdf, next_cdf = torch.sigmoid(prev_sdf * s), torch.sigmoid(next_sdf * s)
    return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)


def sections(spec, z, valid):
    """NeuS's sections of the (N, S) ladder ``z`` whose valid samples
    ``valid`` marks: mid z, lengths and the sections' mask, each (N, S)."""
    n = spec.n_sample
    c = valid.sum(1, keepdim=True)
    slot = torch.arange(z.shape[1], device=z.device)[None]
    # the valid samples first, in ladder order; the rest repeat the last
    key = torch.where(valid, slot, slot + z.shape[1])
    zc = z.gather(1, key.argsort(1))
    zc = torch.where(slot < c, zc, zc.gather(1, (c - 1).clamp_min(0)))
    first, last = zc[:, :1], zc[:, -1:]
    fin = last + (last - first) / n * 0.5 * 2.0
    ext = torch.cat([zc, last], 1)
    ext = torch.where(torch.cat([slot < c, torch.zeros_like(c, dtype=torch.bool)], 1), ext, fin)
    mid = 0.5 * (ext[:, 1:] + ext[:, :-1])
    return mid, ext[:, 1:] - ext[:, :-1], (slot <= c) & (c > 0)


def render_rays(spec, params, bitfield, rays_o, rays_d, bkg, u=None, cos_anneal=1.0, budget=None, prec=F32,
                create_graph=True):
    """Per-ray rgb (N, 3), depth, opacity, and the kept sections' normals
    (K, 3) of one block of rays."""
    near, far, hit = box_near_far(spec.ngp, rays_o, rays_d)
    z, valid = ladder(spec.ngp, near, far, u)
    valid = valid & occupied(spec.ngp, bitfield, rays_o, rays_d, z) & hit[:, None]
    has = valid.any(1)
    mid, dist, mask = sections(spec, z, valid)
    keep = keep_budget(mask, budget)
    ray, slot = torch.nonzero(keep, as_tuple=True)
    d = rays_d[ray]
    pts = rays_o[ray] + mid[ray, slot][:, None] * d
    sdf, feat, normal = sdf_normal(spec, params, pts, create_graph, prec)
    rgb_k = radiance(params, pts, d, normal, feat, prec)
    slope = (d * normal).sum(-1)
    iter_slope = -(torch.relu(-slope * 0.5 + 0.5) * (1 - cos_anneal) + torch.relu(-slope) * cos_anneal)
    a_k = alpha_of(sdf, dist[ray, slot], iter_slope, scale(spec, params))
    alpha = torch.zeros(z.shape, device=z.device).index_put((ray, slot), a_k)
    rgb = torch.zeros(z.shape + (3,), device=z.device).index_put((ray, slot), rgb_k)
    o = torch.where(keep, 1.0 - alpha + 1e-10, 1.0)
    t_incl = torch.cumprod(o, 1)
    w = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1) * alpha
    out_rgb = (w[..., None] * rgb).sum(1) + t_incl[:, -1:] * bkg
    depth, opacity = (w * mid).sum(1), w.sum(1)
    bkg = bkg.expand(out_rgb.shape)
    return (torch.where(has[:, None], out_rgb, bkg), torch.where(has, depth, spec.depth_far),
            torch.where(has, opacity, 0.0), normal)


def losses(rgb, opacity, normal, img, mask):
    """(Huber 0.1 masked, weight 5) + (BCE, weight 0.1) + (eikonal, weight 0.1)."""
    err = (rgb - img).abs()
    huber = torch.where(err <= 0.1, 0.5 * err * err, 0.1 * (err - 0.05))
    img_loss = (huber * mask[:, None]).sum() / (mask.sum().clamp_min(1.0) * 3)
    p = opacity.clamp(1e-7, 1 - 1e-7)
    bce = (-(mask * torch.log(p) + (1 - mask) * torch.log(1 - p))).mean()
    eik = ((torch.linalg.vector_norm(normal, dim=-1) - 1.0) ** 2).mean() if normal.shape[0] else 0.0 * bce
    return 5.0 * img_loss + 0.1 * bce + 0.1 * eik


def train_steps(spec, params, pool, bitfield, generator, n_rays, n_steps, lr, eps, weight_decay, ema_decay,
                prec=F32):
    """``n_steps`` AdamW steps from ``params`` (by leaf name), epoch t = 0,
    1, ... (the slope's anneal), on batches drawn as the program draws them
    (``reference/ngp.py``'s ``train_steps``). Returns each step's loss, each
    leaf's first gradient, the leaves after the steps and the EMA's shadow
    (not debiased)."""
    dev = pool["rays_o"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    shadow = {k: torch.zeros_like(v) for k, v in p.items()}
    out_losses, first = [], None
    n_total = pool["rays_o"].shape[0]
    for t in range(1, n_steps + 1):
        pick = torch.randint(0, n_total, (n_rays,), generator=generator, device=dev)
        color = torch.rand((1, n_rays, 3), generator=generator, device=dev)[0]
        u = torch.rand((n_rays, spec.n_sample), generator=generator, device=dev)
        a = pool["mask"][pick]
        img = pool["img"][pick] * a[:, None] + color * (1.0 - a[:, None])
        cos_anneal = min(1.0, (t - 1) / spec.anneal_end) if spec.anneal_end else 1.0
        rgb, _, opacity, normal = render_rays(spec, p, bitfield, pool["rays_o"][pick], pool["rays_d"][pick], color,
                                              u=u, cos_anneal=cos_anneal, budget=spec.budget, prec=prec)
        loss = losses(rgb, opacity, normal, img, a)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES], allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(LEAVES, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        out_losses.append(float(loss.detach()))
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k]
                p[k].mul_(1 - lr * weight_decay)
                m[k].mul_(BETAS[0]).add_(g * (1 - BETAS[0]))
                v2[k].mul_(BETAS[1]).add_(g * g * (1 - BETAS[1]))
                denom = (v2[k].sqrt() / math.sqrt(1 - BETAS[1]**t)) + eps
                p[k].sub_(lr / (1 - BETAS[0]**t) * m[k] / denom)
                shadow[k].mul_(ema_decay).add_(p[k] * (1 - ema_decay))
    return out_losses, first, {k: v.detach() for k, v in p.items()}, shadow


def est_opacity(spec, params, pts, dt, prec=F32):
    """NeuS's occupancy estimate at (N, 3) points."""
    sdf, _, normal = sdf_normal(spec, params, pts, create_graph=False, prec=prec)
    rays_d = -pts / (torch.linalg.vector_norm(pts, dim=-1, keepdim=True) + 1e-8)
    slope = (rays_d * normal).sum(-1)
    dist = torch.full_like(slope, dt / math.sqrt(3.0))
    return alpha_of(sdf.detach(), dist, -torch.relu(-slope.detach()), scale(spec, params).detach())


def occupancy_points(spec, bitfield, generator):
    """The update's draws: a quarter of the voxels uniform without
    replacement, a quarter from the occupied ones (all, where none is),
    then a uniform jitter u of each, in that order from ``generator``.
    Returns the drawn voxels (N,) and their points (N, 3): the voxel's
    centre, ijk vs + vs / 2 - side / 2 (vs the f32 voxel side), plus (u -
    0.5) vs, rounded step by step as the program places them. NeuS's
    normal jumps where a point crosses a hash cell's face, so points an
    ulp apart can read estimates ~1e-5 apart at the recipe's init."""
    n = spec.n_grid
    n_voxel, dev = n**3, bitfield.device
    k = n_voxel // 4
    uniform = torch.randperm(n_voxel, generator=generator, device=dev)[:k]
    weight = bitfield.reshape(-1).to(torch.float32)
    weight = weight if bool(weight.sum() > 0) else torch.ones_like(weight)
    idx = torch.cat([uniform, torch.multinomial(weight, k, replacement=True, generator=generator)])
    u = torch.rand((idx.shape[0], 3), generator=generator, device=dev)
    ijk = torch.stack([idx // (n * n), (idx // n) % n, idx % n], -1).to(torch.float32)
    size = torch.full((3,), spec.side, dtype=torch.float32, device=dev)
    voxel = size / n
    return idx, ijk * voxel + 0.5 * voxel - size / 2.0 + (u - 0.5) * voxel


@torch.no_grad()
def occupancy_update(spec, params, opafield, bitfield, generator, chunk=1 << 20, prec=F32):
    """``reference/ngp.py``'s occupancy update with NeuS's opacity
    estimate at ``occupancy_points``, in chunks of ``chunk`` points (dt =
    diag / n_sample)."""
    n_voxel, dev = spec.n_grid**3, opafield.device
    idx, pts = occupancy_points(spec, bitfield, generator)
    dt = float(torch.linalg.vector_norm(torch.full((3,), spec.side, dtype=torch.float32))) / spec.n_sample
    opacity = torch.cat([est_opacity(spec, params, pts[s:s + chunk], dt, prec) for s in range(0, pts.shape[0], chunk)])
    peak = torch.full((n_voxel,), -torch.inf, device=dev).scatter_reduce(0, idx, opacity, "amax")
    drawn = torch.zeros((n_voxel,), dtype=torch.bool, device=dev)
    drawn[idx] = True
    old = opafield.reshape(-1)
    new = torch.where(drawn & (old >= 0), torch.maximum(old * spec.ema_decay, peak), old)
    thres = torch.clamp_max(new.clamp_min(0.0).mean(), spec.opa_thres)
    return new.reshape(opafield.shape), (new >= thres).reshape(bitfield.shape)
