"""The plain NGP: the reference that decides whether a run is ``correct``.

Plain torch in float32 (TF32 off), written from the recipe's equations and
sharing no code with the program: the multi-resolution hash grid (dense
levels while (res + 1)^3 fits the table, else the quad or the Instant-NGP
xor hash), the bias-free MLPs (geometry 32 -> 64 -> 16 with exp density,
radiance [view, 15 features] -> 64 -> 64 -> 3 with a sigmoid), the
fixed-step ladder inside the volume's box with the training jitter, the
occupancy mask and its update (the sampled voxels' opacity, an EMA and a
threshold), the per-ray sample cap, the point budget (the first
``budget`` valid samples in ray-major order), alpha compositing over the
kept samples with a background, the Huber loss and Adam.

Departures from the published Instant-NGP are the recipe's own and the
program's: the view direction enters the radiance net unencoded (the
configuration names SH degree 4), and the default hash is the quad hash.

``Precision`` sets what the reference rounds to: ``F32`` rounds nothing;
``CONTROL`` is the control of the correctness check, every precision the
configuration states stepped down once (MLP operands and table reads from
bf16 to fp8 e4m3, compositing and Adam's moments from f32 to bf16). The
ray geometry (origins, directions, z values, points) stays f32 in both:
the ladder's step (0.0068) is below bf16's resolution at z ~ 4.
"""

import math
from dataclasses import dataclass

import torch

CORNERS = ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1))
PRIME_Y, PRIME_Z = 2654435761, 805459861
QUAD_SY = 31
U32 = 0xFFFFFFFF
LEAVES = ("table", "geo.0", "geo.out", "rad.0", "rad.1", "rad.out")
BETAS = (0.9, 0.999)


@dataclass(frozen=True)
class Precision:
    mlp: torch.dtype = None  # operand rounding of the MLPs (f32 accumulation)
    table: torch.dtype = None  # rounding of the table's reads
    march: torch.dtype = torch.float32  # compositing
    moments: torch.dtype = torch.float32  # Adam's moments


F32 = Precision()
CONTROL = Precision(torch.float8_e4m3fn, torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16)


def _round(x, dtype):
    """x rounded to ``dtype`` in the forward, the gradient straight through."""
    if dtype is None:
        return x
    return x + (x.to(dtype).to(x.dtype) - x).detach()


class _TruncExp(torch.autograd.Function):
    """exp, whose gradient reads exp of its input clipped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


# --------------------------------------------------------------- the model
class Spec:
    """The sizes the reference needs, read from a configuration file's
    ``model`` tree."""

    def __init__(self, model):
        enc = model["geometry"]["encoder"]
        self.n_levels, self.n_feat = int(enc["n_levels"]), int(enc["n_feat_per_entry"])
        self.table_size = 1 << int(enc["hashmap_size"])
        scale = math.exp(math.log(enc["max_res"] / enc["base_res"]) / (self.n_levels - 1))
        self.res = [int(math.ceil(enc["base_res"] * scale**i - 1.0)) for i in range(self.n_levels)]
        quad = enc.get("quad_hash", True) and self.n_feat == 2 and self.table_size % 32 == 0
        if quad:
            self.variant = "quad"
        elif enc.get("pair_hash", True):
            raise ValueError("the reference knows the quad and the xor hash, not the pair hash")
        else:
            self.variant = "ngp"
        self.side = float(model["obj_bound"]["volume"]["side"])
        self.n_grid = int(model["obj_bound"]["volume"]["n_grid"])
        self.n_sample = int(model["rays"]["n_sample"])
        self.budget = 1 << int(model["obj_bound"]["log_max_allowance"])
        self.depth_far = float(model["obj_bound"]["depth_far"])
        # the occupancy update's constants (the recipe's defaults where the file names none)
        self.ema_decay = float(model["obj_bound"].get("ema_optim_decay", 0.95))
        self.opa_thres = float(model["obj_bound"].get("opa_thres", 0.01))
        self.w_feat = int(model["geometry"]["W_feat"])


def corners(spec, xyz):
    """(N, 3) points -> per corner, the (N, L) rows of the flattened
    (L T, F) table it reads and its (N, L) trilinear weight."""
    dev = xyz.device
    res = torch.tensor(spec.res, dtype=torch.int64, device=dev)
    half = spec.side / 2.0
    p = ((xyz + half) / spec.side)[:, None, :] * res.to(torch.float32)[None, :, None]  # (N, L, 3)
    i0 = torch.minimum(torch.floor(p).to(torch.int64).clamp_min(0), (res - 1)[None, :, None])
    f = p - i0.to(torch.float32)
    mask = spec.table_size - 1
    n1 = (res + 1)[None, :]
    dense = n1 * n1 * n1 <= spec.table_size
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    base = (torch.arange(spec.n_levels, device=dev) * spec.table_size)[None, :]
    out = []
    for cx, cy, cz in CORNERS:
        x, y, z = x0 + cx, y0 + cy, z0 + cz
        if spec.variant == "quad":
            e_hash = (((x * PRIME_Y + y0 * QUAD_SY + z0) & mask) + cy * QUAD_SY + cz) & mask
        else:
            e_hash = (x ^ ((y * PRIME_Y) & U32) ^ ((z * PRIME_Z) & U32)) & mask
        entry = torch.where(dense, x * n1 * n1 + y * n1 + z, e_hash)
        w = (f[..., 0] if cx else 1 - f[..., 0]) * (f[..., 1] if cy else 1 - f[..., 1]) * \
            (f[..., 2] if cz else 1 - f[..., 2])
        out.append((entry + base, w))
    return out


def hash_entries(spec, xyz):
    """The rows of the flattened table that the points' corners reach."""
    return torch.cat([e.reshape(-1) for e, _ in corners(spec, xyz)])


def hash_features(spec, xyz, table, prec=F32):
    """(N, 3) points -> (N, L F) trilinear features of the (L, T, F) table."""
    flat = _round(table, prec.table).reshape(-1, spec.n_feat)
    out = 0.0
    for entry, w in corners(spec, xyz):
        out = out + flat[entry] * w[..., None]
    return out.reshape(xyz.shape[0], spec.n_levels * spec.n_feat)


def mlp(x, weights, prec=F32):
    """Bias-free chain, ReLU between layers."""
    for i, w in enumerate(weights):
        x = _round(x, prec.mlp) @ _round(w, prec.mlp)
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def density(spec, params, pts, prec=F32):
    """(N, 3) points -> sigma (N,) from the geometry chain alone."""
    geo = mlp(hash_features(spec, pts, params["table"], prec), [params["geo.0"], params["geo.out"]], prec)
    return _TruncExp.apply(geo[:, 0])


def field(spec, params, pts, dirs, prec=F32):
    """(N, 3) points and unit directions -> sigma (N,), rgb (N, 3)."""
    geo = mlp(hash_features(spec, pts, params["table"], prec), [params["geo.0"], params["geo.out"]], prec)
    sigma = _TruncExp.apply(geo[:, 0])
    view = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    h = torch.cat([view, geo[:, 1:1 + spec.w_feat]], -1)
    rgb = torch.sigmoid(mlp(h, [params["rad.0"], params["rad.1"], params["rad.out"]], prec))
    return sigma, rgb


@torch.no_grad()
def occupancy_update(spec, params, opafield, bitfield, generator, prec=F32):
    """The occupancy grid's update after its warm-up. A quarter of the
    voxels drawn uniformly without replacement and a quarter with
    replacement from the occupied ones (all, where none is), in that order
    from ``generator``, then a uniform jitter of each drawn voxel's centre
    within the voxel; each voxel's opacity is the largest sigma * dt (dt =
    diag / n_sample) of its points; a drawn voxel takes max(decay * old,
    opacity), every other keeps its old value, and the voxels at or above
    min(mean opacity, threshold) are occupied. Returns (opafield,
    bitfield)."""
    n = spec.n_grid
    n_voxel, dev = n**3, opafield.device
    k = n_voxel // 4
    uniform = torch.randperm(n_voxel, generator=generator, device=dev)[:k]
    weight = bitfield.reshape(-1).to(torch.float32)
    weight = weight if bool(weight.sum() > 0) else torch.ones_like(weight)
    idx = torch.cat([uniform, torch.multinomial(weight, k, replacement=True, generator=generator)])
    u = torch.rand((idx.shape[0], 3), generator=generator, device=dev)
    ijk = torch.stack([idx // (n * n), (idx // n) % n, idx % n], -1).to(torch.float32)
    pts = (ijk + u) * (spec.side / n) - spec.side / 2.0
    opacity = density(spec, params, pts, prec) * (math.sqrt(3.0) * spec.side / spec.n_sample)
    peak = torch.full((n_voxel,), -torch.inf, device=dev).scatter_reduce(0, idx, opacity, "amax")
    drawn = torch.zeros((n_voxel,), dtype=torch.bool, device=dev)
    drawn[idx] = True
    old = opafield.reshape(-1)
    new = torch.where(drawn & (old >= 0), torch.maximum(old * spec.ema_decay, peak), old)
    thres = torch.clamp_max(new.clamp_min(0.0).mean(), spec.opa_thres)
    return new.reshape(opafield.shape), (new >= thres).reshape(bitfield.shape)


# ------------------------------------------------------------- the sampler
def box_near_far(spec, rays_o, rays_d, eps=1e-7):
    """The slab test against the volume's box: near, far (N, 1), hit (N,)."""
    half = spec.side / 2.0
    parallel = rays_d.abs() < eps
    safe = torch.where(parallel, torch.ones_like(rays_d), rays_d)
    t1, t2 = (-half - rays_o) / safe, (half - rays_o) / safe
    t_near = torch.where(parallel, -torch.inf, torch.minimum(t1, t2)).amax(-1)
    t_far = torch.where(parallel, torch.inf, torch.maximum(t1, t2)).amin(-1)
    outside = ((rays_o < -half) | (rays_o > half)) & parallel
    hit = ~outside.any(-1) & (t_near <= t_far) & (t_far >= 0)
    near = torch.where(hit, t_near.clamp_min(0.0) + eps, 0.0)
    far = torch.where(hit, t_far.clamp_min(0.0) - eps, 0.0)
    return near[:, None], far[:, None], hit


def ladder(spec, near, far, u=None):
    """The fixed-step ladder of ``n_sample`` steps of diag / n_sample from
    near, clamped at far; repeats at the clamp are not samples. ``u`` (N,
    n_sample) uniform draws jitter each sample inside its interval."""
    # the diagonal as the volume's f32 side lengths give it
    diag = float(torch.linalg.vector_norm(torch.full((3,), spec.side, dtype=torch.float32)))
    step = diag / spec.n_sample
    k = torch.arange(spec.n_sample, dtype=torch.float32, device=near.device)[None]
    z = torch.minimum(torch.maximum(near + k * step, near), far)
    valid = torch.cat([torch.ones_like(z[:, :1], dtype=torch.bool), z[:, 1:] != z[:, :-1]], 1)
    if u is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        lower, upper = torch.cat([z[:, :1], mids], 1), torch.cat([mids, z[:, -1:]], 1)
        z = torch.where(valid, lower + (upper - lower) * u, z)
        last = z.gather(1, (valid.sum(1, keepdim=True) - 1).clamp_min(0))
        z = torch.minimum(torch.maximum(z, z[:, :1]), last)
    return z, valid


def occupied(spec, bitfield, rays_o, rays_d, z):
    """(N, S) samples inside the volume whose voxel the bitfield marks."""
    vs = spec.side / spec.n_grid
    n = spec.n_grid
    idx, inside = [], torch.ones_like(z, dtype=torch.bool)
    for a in range(3):
        f = (rays_o[:, a:a + 1] + z * rays_d[:, a:a + 1] + spec.side / 2.0) / vs
        inside &= (f >= 0) & (f < n)
        idx.append(f.to(torch.int64).clamp(0, n - 1))
    return inside & bitfield.reshape(-1)[(idx[0] * n + idx[1]) * n + idx[2]]


def samples(spec, bitfield, rays_o, rays_d, u=None, cap=None):
    """z (N, S), the valid samples (after the cap: the first ``cap`` valid
    samples of a ray) and the rays that have one."""
    near, far, hit = box_near_far(spec, rays_o, rays_d)
    z, valid = ladder(spec, near, far, u)
    valid = valid & occupied(spec, bitfield, rays_o, rays_d, z) & hit[:, None]
    if cap:
        valid = valid & (torch.cumsum(valid.to(torch.int32), 1) <= cap)
    return z, valid, valid.any(1)


def keep_budget(valid, budget):
    """The first ``budget`` valid samples in ray-major order."""
    if budget is None:
        return valid
    rank = torch.cumsum(valid.reshape(-1).to(torch.int64), 0).reshape(valid.shape)
    return valid & (rank <= budget)


def march(sigma, rgb, z, keep, bkg, prec=F32):
    """Alpha compositing over the kept samples of each ray of the (N, S)
    grid: a sample's step reaches the ray's next kept sample (0 for the
    last), T_i = prod_{j<i} (1 - alpha_j + 1e-10), and the background is
    added with the last T. Returns rgb (N, 3), depth, opacity (N,)."""
    dt = prec.march
    zm = torch.where(keep, z, torch.inf)
    z_next = torch.cat([torch.cummin(zm.flip(1), 1).values.flip(1)[:, 1:], torch.full_like(z[:, :1], torch.inf)], 1)
    delta = torch.where(keep & torch.isfinite(z_next), z_next - z, 0.0)
    delta = torch.where(delta.abs() < 1e-5, 0.0, delta).to(dt)
    s = torch.relu(sigma.to(dt)).clamp_max(1e10)
    alpha = torch.where(keep, 1.0 - torch.exp(-s * delta), 0.0)
    o = torch.where(keep, 1.0 - alpha + 1e-10, 1.0)
    t_incl = torch.cumprod(o, 1)
    trans = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    w = trans * alpha
    out_rgb = (w[..., None] * rgb.to(dt)).sum(1) + t_incl[:, -1:] * bkg.to(dt)
    return out_rgb.float(), (w * z.to(dt)).sum(1).float(), w.sum(1).float()


def render_rays(spec, params, bitfield, rays_o, rays_d, bkg, u=None, cap=None, budget=None, prec=F32):
    """Per-ray rgb (N, 3), depth, opacity of one block of rays: rays with
    no valid sample take the background, depth_far and opacity 0."""
    z, valid, has = samples(spec, bitfield, rays_o, rays_d, u, cap)
    keep = keep_budget(valid, budget)
    ray, slot = torch.nonzero(keep, as_tuple=True)
    d = rays_d[ray]
    pts = rays_o[ray] + z[ray, slot][:, None] * d
    sig_k, rgb_k = field(spec, params, pts, d, prec)
    sigma = torch.zeros(z.shape, device=z.device).index_put((ray, slot), sig_k)
    rgb = torch.zeros(z.shape + (3,), device=z.device).index_put((ray, slot), rgb_k)
    out_rgb, depth, opacity = march(sigma, rgb, z, keep, bkg, prec)
    bkg = bkg.expand(out_rgb.shape)
    return (torch.where(has[:, None], out_rgb, bkg), torch.where(has, depth, spec.depth_far),
            torch.where(has, opacity, 0.0))


@torch.no_grad()
def render_frame(spec, params, bitfield, rays_o, rays_d, bkg, cap=None, budget=None, block=16384, prec=F32):
    """A frame's rays rendered in blocks of ``block`` rays, the point budget
    applying to each block as it does to each of the program's chunks."""
    parts = [render_rays(spec, params, bitfield, rays_o[s:s + block], rays_d[s:s + block], bkg, cap=cap,
                         budget=budget, prec=prec)
             for s in range(0, rays_o.shape[0], block)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


# ------------------------------------------------------------ the training
def huber(pred, gt):
    err = (pred - gt).abs()
    return torch.where(err <= 1.0, 0.5 * err * err, err - 0.5).mean()


def train_steps(spec, params, pool, bitfield, generator, n_rays, n_steps, lr, eps, prec=F32):
    """``n_steps`` optimizer steps from ``params`` (by leaf name) on batches
    drawn as the program draws them: per step, ``n_rays`` picks of the pool
    (uniform, with replacement), a random background (1, n, 3) composited
    under the pool's masks, then a (n, n_sample) uniform jitter. Returns
    each step's loss, each leaf's first gradient and the leaves after the
    steps."""
    dev = pool["rays_o"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros(v.shape, dtype=prec.moments, device=dev) for k, v in p.items()}
    v2 = {k: torch.zeros(v.shape, dtype=prec.moments, device=dev) for k, v in p.items()}
    losses, first = [], None
    n_total = pool["rays_o"].shape[0]
    for t in range(1, n_steps + 1):
        pick = torch.randint(0, n_total, (n_rays,), generator=generator, device=dev)
        color = torch.rand((1, n_rays, 3), generator=generator, device=dev)[0]
        u = torch.rand((n_rays, spec.n_sample), generator=generator, device=dev)
        a = pool["mask"][pick][:, None]
        img = pool["img"][pick] * a + color * (1.0 - a)
        rgb, _, _ = render_rays(spec, p, bitfield, pool["rays_o"][pick], pool["rays_d"][pick], color, u=u,
                                   budget=spec.budget, prec=prec)
        loss = huber(rgb, img)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES], allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(LEAVES, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k].to(prec.moments)
                m[k].mul_(BETAS[0]).add_(g * (1 - BETAS[0]))
                v2[k].mul_(BETAS[1]).add_(g * g * (1 - BETAS[1]))
                denom = (v2[k].float().sqrt() / math.sqrt(1 - BETAS[1]**t)) + eps
                p[k].sub_(lr / (1 - BETAS[0]**t) * m[k].float() / denom)
    return losses, first, {k: v.detach() for k, v in p.items()}
