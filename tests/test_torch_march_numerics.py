"""Models of two kernels' designs on the CPU, held against the plain
versions and the JAX package:

- kernel F (``csrc/segment_march_bwd.cu``): a plain-PyTorch model of its
  warp order - each ray on a group of 32 lanes, 32 samples a chunk, the
  transmittance a shuffle product scan with a carry from chunk to chunk,
  and the backward recurrence a reverse shuffle scan of affine maps
  walked from the segment's end - on streams of 0-512 samples a ray
  (``arcnerf_torch/tools/march_streams.py``), against
  ``segment_march_bwd_reference`` and ``jax.grad`` of the JAX
  ``segment_march``;
- kernel B (``csrc/hash_encode.cu``): a numpy model of its level-major
  mapping (32 points a block, one warp a level, levels in chunks of 16)
  and of its shared-memory output tile, which must write every (point,
  level, feature) once, to the right row and column, equal to
  ``hash_encode_reference`` bit for bit.

The group width, the block's points and warps and the tile's padding are
read from the kernels' sources."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.render.ray_helper import segment_march as jax_segment_march
from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, _corners_and_weights, hash_encode_reference
from arcnerf_torch.render.ray_helper import segment_march_bwd_reference, segment_march_reference
from arcnerf_torch.tools.hash_streams import one_cell_stream, pad_stream, ray_stream
from arcnerf_torch.tools.march_streams import BOUNDARY_LENGTHS, long_tail_lengths, ray_gradients, segment_stream

CSRC = Path(__file__).resolve().parents[1] / "arcnerf_torch" / "csrc"


def _constant(source, name):
    match = re.search(r"constexpr int {} = (\d+);".format(name), (CSRC / source).read_text())
    assert match, "{} not found in {}".format(name, source)
    return int(match.group(1))


F_GROUP = _constant("segment_march_bwd.cu", "kGroup")
B_POINTS = _constant("hash_encode.cu", "kPoints")
B_WARPS = _constant("hash_encode.cu", "kWarps")
B_PAD = int(re.search(r"kStride = kWarps \* F \+ (\d+);", (CSRC / "hash_encode.cu").read_text()).group(1))


# ------------------------------------------------------------ kernel F

def _shift_up(v, d):
    """__shfl_up_sync(v, d, W) along the last axis: lane i reads lane i - d
    (lanes below d read their own value)."""
    return torch.cat([v[..., :d], v[..., :-d]], -1)


def _shift_down(v, d):
    """__shfl_down_sync(v, d, W): lane i reads lane i + d (the top d lanes
    read their own value)."""
    return torch.cat([v[..., d:], v[..., -d:]], -1)


def product_scan(v):
    """seg_scan::product_scan over the last axis (W lanes), step by step."""
    lane = torch.arange(v.shape[-1])
    d = 1
    while d < v.shape[-1]:
        v = torch.where(lane >= d, _shift_up(v, d) * v, v)
        d *= 2
    return v


def suffix_scan(a, o):
    """seg_scan::suffix_scan: lane i gets f_i o ... o f_(W-1) of the affine
    maps R -> a + o R, step by step (f after g: a_f + o_f a_g, o_f o_g)."""
    lane, w = torch.arange(a.shape[-1]), a.shape[-1]
    d = 1
    while d < w:
        ga, go = _shift_down(a, d), _shift_down(o, d)
        take = lane + d < w
        a, o = torch.where(take, a + o * ga, a), torch.where(take, o * go, o)
        d *= 2
    return a, o


def model_segment_march_bwd(sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z=False, bkg=None,
                            white_bkg=False, w=F_GROUP):
    """Kernel F's order of operations in f32, all rays in lockstep: chunk k
    of every ray holds its samples k w .. k w + w - 1 on lanes 0..w-1. The
    forward walk parks T_i in d_sigma (the last chunk's T stays as it is),
    the backward walk runs from each ray's last chunk to its first."""
    k_total, n_rays = sigma.shape[0], off.shape[0]
    start = off.clamp_max(k_total)
    end = (off + cnt).clamp_max(k_total)
    live = (cnt > 0) & (start < end)
    n_chunks = torch.where(live, (end - start + w - 1) // w, 0)
    lanes = torch.arange(w)
    d_sigma, d_rgb = torch.zeros_like(sigma), torch.zeros_like(rgb)

    def load(k):
        i = start[:, None] + k * w + lanes  # (n_rays, w)
        inn = (i < end[:, None]) & live[:, None]
        ic = i.clamp(0, k_total - 1)
        zi = torch.where(inn, z[ic], 0.0)
        z_next = _shift_down(zi, 1)
        has_next = (i + 1 < end[:, None]) & live[:, None]
        z_next[:, -1] = torch.where(has_next[:, -1], z[(i[:, -1] + 1).clamp_max(k_total - 1)], z_next[:, -1])
        d = z_next - zi
        delta = torch.where(has_next, torch.where(d.abs() < 1e-5, 0.0, d), 1e10 if add_inf_z else 0.0)
        s_raw = torch.where(inn, sigma[ic], 0.0)
        ex = torch.exp(-s_raw.clamp(0.0, 1e10) * delta)
        alpha = torch.where(inn, 1.0 - ex, 0.0)
        o = torch.where(inn, (1.0 - alpha) + 1e-10, 1.0)
        return i, ic, inn, zi, s_raw, delta, ex, alpha, o

    carry = torch.ones(n_rays)
    t_last = torch.ones(n_rays, w)
    for k in range(int(n_chunks.max()) if n_rays else 0):
        active = k < n_chunks
        i, ic, inn, *_, o = load(k)
        incl = product_scan(o)
        excl = _shift_up(incl, 1)
        t = torch.where(lanes == 0, carry[:, None], carry[:, None] * excl)
        park = (active & (k < n_chunks - 1))[:, None].expand(-1, w)
        d_sigma[ic[park]] = t[park]
        t_last = torch.where((k == n_chunks - 1)[:, None], t, t_last)
        carry = torch.where(active, carry * incl[:, -1], carry)

    gr, gg, gb = g_rgb[:, 0], g_rgb[:, 1], g_rgb[:, 2]
    gm = g_mask.clone()
    if bkg is not None:
        R = bkg[:, 0] * gr + bkg[:, 1] * gg + bkg[:, 2] * gb
    else:
        R = torch.zeros(n_rays)
        if white_bkg:
            gm = gm - (gr + gg + gb)
    for k in reversed(range(int(n_chunks.max()) if n_rays else 0)):
        active = k < n_chunks
        i, ic, inn, zi, s_raw, delta, ex, alpha, o = load(k)
        t = torch.where((k == n_chunks - 1)[:, None], t_last, d_sigma[ic])
        c = rgb[ic]
        G = torch.where(inn, gm[:, None] + zi * g_depth[:, None] + c[..., 0] * gr[:, None] + c[..., 1] * gg[:, None]
                        + c[..., 2] * gb[:, None], 0.0)
        a_in, o_in = suffix_scan(torch.where(inn, alpha * G, 0.0), o)
        above_a, above_o = _shift_down(a_in, 1), _shift_down(o_in, 1)
        above_a[:, -1], above_o[:, -1] = 0.0, 1.0
        r_i = above_a + above_o * R[:, None]
        R = torch.where(active, a_in[:, 0] + o_in[:, 0] * R, R)
        keep = inn & active[:, None]
        d_alpha = t * (G - r_i)
        ds = torch.where((s_raw > 0) & (s_raw < 1e10), d_alpha * delta * ex, 0.0)
        d_sigma[ic[keep]] = ds[keep]
        wt = (t * alpha)[keep]
        d_rgb[ic[keep]] = wt[:, None] * g_rgb[torch.arange(n_rays)[:, None].expand_as(ic)[keep]]
    return d_sigma, d_rgb


def _f_stream(kind, n_rays=512):
    """A long-tail stream (0-512 samples a ray, every chunk boundary among
    them), one whose budget clips a ray and empties the rest, or short rays
    (0-32) in a ragged number."""
    if kind == "short":
        n_rays = 333
    lengths = long_tail_lengths(n_rays, 40, max_len=32 if kind == "short" else 512)
    k_total = int(lengths.sum()) * 3 // 5 if kind == "clipped" else int(lengths.sum()) + 37
    sigma, rgb, z, off, cnt = segment_stream(lengths, k_total, 41)
    g_rgb, g_depth, g_mask, bkg = ray_gradients(n_rays, 42)
    return sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, bkg


F_FLAGS = [(False, False, True), (True, False, False), (False, True, False), (True, False, True)]


def _torch_args(stream, add_inf_z, white_bkg, use_bkg, dtype=torch.float32):
    sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, bkg = stream
    f = [torch.from_numpy(a).to(dtype) for a in (sigma, rgb, z)]
    g = [torch.from_numpy(a).to(dtype) for a in (g_rgb, g_depth, g_mask)]
    return (*f, torch.from_numpy(off), torch.from_numpy(cnt), *g, add_inf_z,
            torch.from_numpy(bkg).to(dtype) if use_bkg else None, white_bkg)


def test_the_streams_hold_every_chunk_boundary_and_a_clipped_ray():
    for kind in ("long_tail", "clipped"):
        *_, off, cnt, _, _, _, _ = _f_stream(kind)
        lengths = long_tail_lengths(512, 40)
        assert set(BOUNDARY_LENGTHS) <= set(lengths.tolist()) and lengths.max() == 512
        k_total = _f_stream(kind)[0].shape[0]
        n_in = np.minimum(off + cnt, k_total) - np.minimum(off, k_total)
        if kind == "clipped":
            crossing = (off < k_total) & (off + lengths > k_total)
            assert crossing.sum() == 1 and 0 < cnt[crossing][0] < lengths[crossing][0]
            assert (cnt[off >= k_total] == 0).all() and (off >= k_total).sum() > 10
        else:
            assert (n_in == lengths).all()
    assert (long_tail_lengths(333, 40, max_len=32) <= 32).all()


def test_scans_follow_the_plain_recurrences():
    # the shuffle scans against a sequential product and recurrence, in
    # float64 where only the order differs
    rng = np.random.default_rng(43)
    o = torch.from_numpy(rng.uniform(0.5, 1.0, size=(64, F_GROUP)))
    torch.testing.assert_close(product_scan(o), torch.cumprod(o, -1), rtol=1e-13, atol=0)
    a = torch.from_numpy(rng.normal(size=(64, F_GROUP)))
    sa, so = suffix_scan(a, o)
    for lane in (0, 5, F_GROUP - 1):
        r = torch.from_numpy(rng.normal(size=64))
        want = r.clone()
        for j in reversed(range(lane, F_GROUP)):
            want = a[:, j] + o[:, j] * want
        torch.testing.assert_close(sa[:, lane] + so[:, lane] * r, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["long_tail", "clipped", "short"])
@pytest.mark.parametrize("add_inf_z,white_bkg,use_bkg", F_FLAGS)
def test_model_of_kernel_f_matches_the_plain_version(kind, add_inf_z, white_bkg, use_bkg):
    # the model in f32 within 1e-5 of the largest value of the plain
    # version in float64: the tree order costs a few f32 roundings a sample
    # (F_TOL on the card is 1e-4)
    stream = _f_stream(kind)
    got = model_segment_march_bwd(*_torch_args(stream, add_inf_z, white_bkg, use_bkg))
    exact = segment_march_bwd_reference(*_torch_args(stream, add_inf_z, white_bkg, use_bkg, torch.float64))
    plain = segment_march_bwd_reference(*_torch_args(stream, add_inf_z, white_bkg, use_bkg))
    k_in = int(stream[4].sum())
    for name, a, b, p in zip(("d_sigma", "d_rgb"), got, exact, plain):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale, name
        assert float((p.double() - b).abs().max()) <= 1e-5 * scale, name
        assert torch.all(a[k_in:] == 0), name  # padding rows untouched
    if not add_inf_z:
        assert int((got[0] != 0).sum()) > 100


@pytest.mark.parametrize("w", [8, 16])
def test_model_of_kernel_f_at_other_group_widths(w):
    # several rays a warp on groups of 8 or 16 lanes: the same function
    stream = _f_stream("long_tail")
    got = model_segment_march_bwd(*_torch_args(stream, False, False, True), w=w)
    exact = segment_march_bwd_reference(*_torch_args(stream, False, False, True, torch.float64))
    for a, b in zip(got, exact):
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("kind", ["long_tail", "clipped"])
@pytest.mark.parametrize("add_inf_z,white_bkg,use_bkg", F_FLAGS[:3])
def test_model_of_kernel_f_matches_jax_grad(kind, add_inf_z, white_bkg, use_bkg):
    # against jax.grad of the JAX segment_march (padding rows on ray 0, as
    # the compaction leaves them): 1e-4 of the largest value, since JAX
    # differentiates per-ray sums taken from one stream-wide f32 cumsum
    sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, bkg = stream = _f_stream(kind, n_rays=256)
    n_rays, k_total = off.shape[0], sigma.shape[0]
    ray_id = np.zeros(k_total, np.int32)
    ray_id[:int(cnt.sum())] = np.repeat(np.arange(n_rays), cnt)
    color = bkg if use_bkg else None

    def jax_loss(s, c):
        out = jax_segment_march(s, c, jnp.asarray(z), jnp.asarray(ray_id), jnp.asarray(off), jnp.asarray(cnt), n_rays,
                                add_inf_z=add_inf_z, white_bkg=white_bkg,
                                bkg_color=None if color is None else jnp.asarray(color))
        return jnp.sum(out["rgb"] * g_rgb) + jnp.sum(out["depth"] * g_depth) + jnp.sum(out["mask"] * g_mask)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(sigma), jnp.asarray(rgb))
    got = model_segment_march_bwd(*_torch_args(stream, add_inf_z, white_bkg, use_bkg))
    for name, a, b in zip(("d_sigma", "d_rgb"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), rtol=0, err_msg=name)


# ------------------------------------------------------------ kernel B

def model_hash_encode(xyz, table, res, aabb_min, aabb_len, variant, read_bf16):
    """Kernel B's blocks, warps, lanes and shared-memory tile in numpy:
    returns the output and how many times each of its values was written.
    A lane's value is its (point, level)'s corner entries read (rounded to
    bf16) and summed in corner order in f32, as the kernel sums them."""
    n_pts, (n_levels, table_size, n_feat) = xyz.shape[0], table.shape
    entries, weights = _corners_and_weights(torch.from_numpy(xyz), res, aabb_min, aabb_len, table_size, variant)
    tab = torch.from_numpy(table)
    if read_bf16:
        tab = tab.to(torch.bfloat16).float()
    tab = tab.numpy()
    row, stride = n_levels * n_feat, B_WARPS * n_feat + B_PAD
    warps = min(n_levels, B_WARPS)
    threads = 32 * warps
    out = np.full(n_pts * row, np.nan, np.float32)
    writes = np.zeros(n_pts * row, np.int64)
    lane = np.arange(32)
    for block in range((n_pts + B_POINTS - 1) // B_POINTS):
        p0 = block * B_POINTS
        n_here = min(B_POINTS, n_pts - p0)
        for l0 in range(0, n_levels, B_WARPS):
            chunk = min(B_WARPS, n_levels - l0)
            tile = np.full(B_POINTS * stride, np.nan, np.float32)
            for warp in range(min(chunk, warps)):
                lv, pts = l0 + warp, p0 + lane[:n_here]
                acc = np.zeros((n_here, n_feat), np.float32)
                for e, w in zip(entries, weights):
                    v = tab[lv, e[pts, lv].numpy()]
                    acc = acc + v * w[pts, lv].numpy()[:, None]
                addr = lane[:n_here, None] * stride + warp * n_feat + np.arange(n_feat)
                # one store instruction a feature: its 32 lanes in 32 banks
                for f in range(n_feat):
                    assert len(set((addr[:, f] % 32).tolist())) == n_here
                tile[addr] = acc
            cols = chunk * n_feat
            for i0 in range(0, n_here * cols, threads):  # the block's threads, a pass at a time
                i = np.arange(i0, min(i0 + threads, n_here * cols))
                r, c = i // cols, i % cols
                dst = (p0 + r) * row + l0 * n_feat + c
                out[dst] = tile[r * stride + c]
                np.add.at(writes, dst, 1)
    return out.reshape(n_pts, row), writes.reshape(n_pts, row)


@pytest.mark.parametrize("kind", ["ray", "one_cell", "padded", "ragged"])
@pytest.mark.parametrize("n_feat", [1, 2, 4, 8])
def test_model_of_kernel_b_writes_every_value_once_and_equals_the_plain_version(kind, n_feat):
    # bit for bit: the same entries, weights and corner order as the plain version
    n_pts = 1000 if kind == "ragged" else 320
    xyz = one_cell_stream(n_pts, 44) if kind == "one_cell" else ray_stream(n_pts, 44)
    if kind == "padded":
        xyz, _ = pad_stream(xyz, np.zeros((n_pts, 1), np.float32), n_pts * 3 // 4)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=n_feat, hashmap_size=12, side=2.0, include_input=False)
    table = np.random.default_rng(45).uniform(-1, 1, size=(16, 1 << 12, n_feat)).astype(np.float32)
    for variant, read_bf16 in (("quad", True), ("ngp", False)):
        out, writes = model_hash_encode(xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, variant, read_bf16)
        assert (writes == 1).all()
        ref = hash_encode_reference(torch.from_numpy(xyz), torch.from_numpy(table), enc.resolutions, enc.aabb_min,
                                    enc.aabb_len, variant, read_bf16).numpy()
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("n_levels", [2, 3, 17, 33])
def test_model_of_kernel_b_takes_any_number_of_levels(n_levels):
    # fewer levels than warps leave warps idle; more go in chunks of 16
    xyz = ray_stream(100, 46)
    enc = HashGridEmbedder(n_levels=n_levels, n_feat_per_entry=2, hashmap_size=10, side=2.0, base_res=4,
                           max_res=max(8, 64 * n_levels), include_input=False)
    table = np.random.default_rng(47).uniform(-1, 1, size=(n_levels, 1 << 10, 2)).astype(np.float32)
    out, writes = model_hash_encode(xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, "pair", True)
    assert (writes == 1).all()
    ref = hash_encode_reference(torch.from_numpy(xyz), torch.from_numpy(table), enc.resolutions, enc.aabb_min,
                                enc.aabb_len, "pair", True).numpy()
    assert np.array_equal(out, ref)


def test_model_of_kernel_b_sees_a_wrong_tile_mapping():
    # the model would catch a tile row without its padding (32-way bank
    # conflicts) and a write-out that mixes up rows
    xyz = ray_stream(64, 48)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=10, side=2.0, include_input=False)
    table = np.random.default_rng(49).uniform(-1, 1, size=(16, 1 << 10, 2)).astype(np.float32)
    args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, "quad", True)
    global B_PAD
    pad = B_PAD
    try:
        B_PAD = 0
        with pytest.raises(AssertionError):
            model_hash_encode(*args)
    finally:
        B_PAD = pad
    out, _ = model_hash_encode(*args)
    ref = hash_encode_reference(torch.from_numpy(xyz), torch.from_numpy(table), *args[2:]).numpy()
    assert np.array_equal(out, ref) and not np.array_equal(out[::-1], ref)


@pytest.mark.parametrize("study,names", [("hash_encode_designs", {"design_hash_encode"}),
                                         ("march_designs", {"design_segment_march_bwd"})])
def test_design_studies_run_on_the_card_only(study, names):
    import importlib

    module = importlib.import_module("design_studies." + study)
    with pytest.raises(RuntimeError, match="card only"):
        module.main([])
    assert set(re.findall(r'extern "C" int (design_\w+)\(', module.SOURCE.read_text())) == names


# ------------------------------------------------------------ kernel C

C_GROUPS = tuple(sorted((int(w) for w in re.findall(r"case (\d+): launch<", (CSRC / "segment_march.cu").read_text())),
                        reverse=True))


def _group_sum(v):
    """seg_scan::group_sum over the last axis: butterfly steps d = W/2 .. 1,
    lane i adding lane i ^ d; returns lane 0's sum."""
    lane, w = torch.arange(v.shape[-1]), v.shape[-1]
    d = w // 2
    while d >= 1:
        v = v + v[..., lane ^ d]
        d //= 2
    return v[..., 0]


def model_segment_march_fwd(sigma, rgb, z, off, cnt, add_inf_z=False, bkg=None, white_bkg=False, w=32):
    """Kernel C's order of operations in f32, all rays in lockstep: chunk k
    of every ray holds its samples k w .. k w + w - 1 on lanes 0..w-1; T is
    the chunk's product scan times the carry, each lane sums its own
    samples' w, w z and w rgb over the chunks, and the group adds the lanes'
    sums at the end."""
    k_total, n_rays = sigma.shape[0], off.shape[0]
    start = off.clamp_max(k_total)
    end = (off + cnt).clamp_max(k_total)
    n_chunks = torch.where(end > start, (end - start + w - 1) // w, 0)
    lanes = torch.arange(w)
    carry = torch.ones(n_rays)
    sums = torch.zeros(5, n_rays, w)  # w, w z, w r, w g, w b a lane
    for k in range(int(n_chunks.max()) if n_rays else 0):
        active = k < n_chunks
        i = start[:, None] + k * w + lanes
        inn = (i < end[:, None]) & active[:, None]
        ic = i.clamp(0, k_total - 1)
        zi = torch.where(inn, z[ic], 0.0)
        z_next = _shift_down(zi, 1)
        has_next = (i + 1 < end[:, None]) & active[:, None]
        z_next[:, -1] = torch.where(has_next[:, -1], z[(i[:, -1] + 1).clamp_max(k_total - 1)], z_next[:, -1])
        d = z_next - zi
        delta = torch.where(has_next, torch.where(d.abs() < 1e-5, 0.0, d), 1e10 if add_inf_z else 0.0)
        s = torch.where(inn, sigma[ic], 0.0).clamp(0.0, 1e10)
        alpha = torch.where(inn, 1.0 - torch.exp(-s * delta), 0.0)
        o = torch.where(inn, (1.0 - alpha) + 1e-10, 1.0)
        incl = product_scan(o)
        t = torch.where(lanes == 0, carry[:, None], carry[:, None] * _shift_up(incl, 1))
        wt = t * alpha
        c = rgb[ic]
        terms = torch.stack([wt, wt * zi, wt * c[..., 0], wt * c[..., 1], wt * c[..., 2]])
        sums = torch.where(inn, sums + terms, sums)
        carry = torch.where(active, carry * incl[:, -1], carry)
    mask, depth, r, g, b = _group_sum(sums)
    trans = torch.where(cnt <= 0, 1.0, carry)
    out = torch.stack([r, g, b], -1)
    if bkg is not None:
        out = out + trans[:, None] * bkg
    elif white_bkg:
        out = out + (1.0 - mask)[:, None]
    return {"rgb": out, "depth": depth, "mask": mask, "trans_end": trans}


def _c_stream(kind):
    """Kernel C's streams: segments of 0-512 samples (every chunk boundary
    and empty rays among them), a budget that clips one ray and empties the
    rest, or the serving cap's 0-16 samples (40 % of rays empty), with a
    background a ray."""
    if kind == "cap16":
        rng = np.random.default_rng(50)
        lengths = rng.integers(0, 17, size=600)
        lengths[rng.random(600) < 0.4] = 0
        lengths[:6] = (0, 1, 4, 5, 8, 16)
    else:
        lengths = long_tail_lengths(512, 40)
    k_total = int(lengths.sum()) * 3 // 5 if kind == "clipped" else int(lengths.sum()) + 37
    sigma, rgb, z, off, cnt = segment_stream(lengths, k_total, 51)
    bkg = ray_gradients(len(lengths), 52)[3]
    return sigma, rgb, z, off, cnt, bkg


# every add_inf_z case under no background, white_bkg and a background a ray
C_FLAGS = [(a, white, use_bkg) for a in (False, True) for white, use_bkg in ((False, False), (True, False),
                                                                             (False, True))]


def _c_args(stream, add_inf_z, white_bkg, use_bkg, dtype=torch.float32):
    sigma, rgb, z, off, cnt, bkg = stream
    f = [torch.from_numpy(a).to(dtype) for a in (sigma, rgb, z)]
    return (*f, torch.from_numpy(off), torch.from_numpy(cnt), add_inf_z,
            torch.from_numpy(bkg).to(dtype) if use_bkg else None, white_bkg)


def test_kernel_c_takes_the_groups_the_wrapper_picks():
    from arcnerf_torch.render.ray_helper import CAPPED_GROUP, TRAIN_GROUP, march_group

    # the kernel ships the two widths the package's callers take
    assert C_GROUPS == (32, 8)
    assert TRAIN_GROUP == 32 and CAPPED_GROUP == 8
    assert march_group(None) == march_group(0) == march_group(512) == march_group(17) == TRAIN_GROUP
    assert march_group(32) == TRAIN_GROUP and march_group(16) == march_group(4) == CAPPED_GROUP
    text = (CSRC / "seg_scan.cuh").read_text()
    assert "struct Sample" in text and "finish_sample" in text  # one definition of a sample for C and F
    assert "seg_scan::load_sample<W, Alpha>(" in (CSRC / "segment_march_bwd.cu").read_text()
    assert "seg_scan::finish_sample<W, Alpha, Tail>(" in (CSRC / "segment_march.cu").read_text()
    for name in ("segment_march.cu", "segment_march_bwd.cu"):
        assert "struct Sample" not in (CSRC / name).read_text(), name


def test_the_cap16_stream_holds_short_and_empty_rays():
    *_, off, cnt, _ = _c_stream("cap16")
    assert cnt.max() == 16 and (cnt == 0).mean() > 0.3 and {1, 4, 5, 8} <= set(cnt.tolist())


@pytest.mark.parametrize("kind", ["long_tail", "clipped", "cap16"])
@pytest.mark.parametrize("add_inf_z,white_bkg,use_bkg", C_FLAGS)
@pytest.mark.parametrize("w", [32, 16, 8, 4])
def test_model_of_kernel_c_matches_the_plain_version(kind, add_inf_z, white_bkg, use_bkg, w):
    # the model in f32 against the plain version in float64: atol = rtol =
    # 1e-5, a few f32 roundings a sample in tree order (C_TOL on the card,
    # where expf differs from the CPU's exp by ulps, is 1e-4); the plain
    # version in f32 within the same bound
    stream = _c_stream(kind)
    got = model_segment_march_fwd(*_c_args(stream, add_inf_z, white_bkg, use_bkg), w=w)
    exact = segment_march_reference(*_c_args(stream, add_inf_z, white_bkg, use_bkg, torch.float64))
    plain = segment_march_reference(*_c_args(stream, add_inf_z, white_bkg, use_bkg))
    for k in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(got[k].double(), exact[k], atol=1e-5, rtol=1e-5, msg=k)
        torch.testing.assert_close(plain[k].double(), exact[k], atol=1e-5, rtol=1e-5, msg=k)
    n = np.minimum(stream[3] + stream[4], stream[0].shape[0]) - np.minimum(stream[3], stream[0].shape[0])
    assert (got["mask"].numpy()[n == 0] == 0).all() and (got["trans_end"].numpy()[n == 0] == 1).all()
    assert float(got["mask"].max()) > 0.5


@pytest.mark.parametrize("kind", ["long_tail", "clipped", "cap16"])
@pytest.mark.parametrize("add_inf_z,white_bkg,use_bkg", C_FLAGS)
def test_model_of_kernel_c_matches_jax(kind, add_inf_z, white_bkg, use_bkg):
    # against the JAX segment_march (padding rows on ray 0, as the
    # compaction leaves them) at 32, 16 and 8 lanes: atol 1e-5 plus two f32
    # ulps of the stream's running total, since JAX takes each ray's sum as
    # a difference of one stream-wide f32 cumsum (tests/test_torch_render.py)
    sigma, rgb, z, off, cnt, bkg = stream = _c_stream(kind)
    n_rays, k_total = off.shape[0], sigma.shape[0]
    ray_id = np.zeros(k_total, np.int32)
    ray_id[:int(cnt.sum())] = np.repeat(np.arange(n_rays), cnt)
    march = jax.jit(jax_segment_march, static_argnames=("n_rays", "add_inf_z", "white_bkg"))
    want = march(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(z), jnp.asarray(ray_id), jnp.asarray(off),
                 jnp.asarray(cnt), n_rays=n_rays, add_inf_z=add_inf_z, white_bkg=white_bkg,
                 bkg_color=jnp.asarray(bkg) if use_bkg else None)
    for w in (32, 16, 8):
        got = model_segment_march_fwd(*_c_args(stream, add_inf_z, white_bkg, use_bkg), w=w)
        for k in ("rgb", "depth", "mask", "trans_end"):
            total = 0.0 if k == "trans_end" else float(np.abs(got[k].numpy()).sum())
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5 + 2 * np.finfo(np.float32).eps * total, rtol=0,
                                       err_msg="{} at {} lanes".format(k, w))

