"""A numpy model of kernel I's partition route (``csrc/scatter_add_rows.cu``,
the W = 1 row scatter-add at kernel E's scale) on the CPU: its four passes -
the bucket histogram, the scan of the totals, the staged scatter of each
tile into bucket order, the per-bucket sums added into the table - held
against float64 ``np.add.at`` and against the XLA scatter-add that
``scripts/probe_scatter.py``'s tails compute (``.at[idx].add(g)``), on the
index sets of ``arcnerf_torch/tools/scatter_streams.py``. The bucket width,
the tile and the route's thresholds are read from the kernel's source, their
one copy: the binding asks the source for the scratch, and the wrapper
passes only the tensors."""

import inspect
import re

import numpy as np
import pytest

import jax.numpy as jnp

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops import gather_scatter as gs
from arcnerf_torch.tools.scatter_streams import KINDS, SOURCE, index_set, partition_constants, values

CONSTANTS = partition_constants()
LOG_BUCKET = CONSTANTS["kLogBucket"]
TILE = CONSTANTS["kPartThreads"] * CONSTANTS["kPerThread"]
I_TOL = 1e-5  # chip_smoke.I_TOL: f32 sums in another order, relative to the largest value


def model_partition(out, idx, g, log_bucket=LOG_BUCKET, tile=TILE, reserve=True):
    """The four passes in numpy, f32 like the kernel: each tile's run in a
    bucket rounded up to an even length by a padding update (the bucket's
    first entry, value 0), so that updates travel two at a time. The card's
    order of shared and global atomics varies from run to run; the model
    takes the tiles (one a block) and each tile's updates in order. Returns
    the table, the keys in bucket order (padding -1) and how many times
    each slot of the scratch was written. ``reserve=False`` leaves the
    cursors where the scan put them (a broken pass 3)."""
    n, n_table = idx.shape[0], out.shape[0]
    bucket = 1 << log_bucket
    nb = -(-n_table // bucket)
    tiles = [slice(t0, t0 + tile) for t0 in range(0, n, tile)]
    # 1. each tile's counts a bucket, rounded up to even, into the totals; 2. the scan
    totals = np.zeros(nb, np.int64)
    for sl in tiles:
        count = np.bincount(idx[sl] >> log_bucket, minlength=nb)
        totals += count + (count & 1)
    base = np.cumsum(totals) - totals
    assert (base % 2 == 0).all()
    cursor = base.copy()
    slots = int(totals.sum())
    assert slots <= n + len(tiles) * nb
    # 3. each tile: ranks within its buckets, an even run reserved a bucket,
    #    staged in bucket order with a padding update closing each odd run
    keys, vals, writes = np.full(slots, -1, np.int64), np.zeros(slots, np.float32), np.zeros(slots, np.int64)
    for sl in tiles:
        k, v = idx[sl], g[sl, 0]
        b = k >> log_bucket
        count = np.bincount(b, minlength=nb)
        even = count + (count & 1)
        start = np.cumsum(even) - even
        order = np.argsort(b, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size) - (np.cumsum(count) - count)[b[order]]
        run = cursor.copy()
        if reserve:
            cursor += even
        staged_k = np.full(int(even.sum()), -1, np.int64)
        staged_v = np.zeros(int(even.sum()), np.float32)
        staged_k[start[b] + rank], staged_v[start[b] + rank] = k, v
        pad = np.flatnonzero(count & 1)
        staged_k[start[pad] + count[pad]] = pad << log_bucket  # value 0
        s = np.arange(staged_k.size)
        sb = staged_k >> log_bucket
        assert (sb[0::2] == sb[1::2]).all()  # a unit of two updates stays in one bucket
        pos = run[sb] + (s - start[sb])
        assert (pos[0::2] % 2 == 0).all()
        keys[pos], vals[pos] = np.where(np.isin(s, start[pad] + count[pad]), -1, staged_k), staged_v
        np.add.at(writes, pos, 1)
    assert (writes == 1).all(), "a slot of the scratch written {} times".format(writes.max())
    if reserve:
        assert (cursor == base + totals).all()
    # 4. a bucket at a time: the non-zero values' f32 sums in a tile, added
    #    into the table where non-zero; the 16-bit keys are bucket-local
    out = out.copy()
    for b in range(nb):
        lo, hi = base[b], base[b] + totals[b]
        kb, vb = keys[lo:hi], vals[lo:hi]
        real = kb >= 0
        assert ((kb[real] >> log_bucket) == b).all() and ((kb[real] & (bucket - 1)) < 1 << 16).all()
        tile_sum = np.zeros(bucket, np.float32)
        nz = vb != 0
        np.add.at(tile_sum, kb[nz] & (bucket - 1), vb[nz])
        rows = min(bucket, n_table - b * bucket)
        hit = tile_sum[:rows] != 0
        seg = out[b * bucket:b * bucket + rows, 0]
        seg[hit] = seg[hit] + tile_sum[:rows][hit]
    return out, keys[keys >= 0], writes


def _case(kind, n=1 << 15, n_table=(1 << 16) + 1000, seed=60):
    return index_set(kind, n, n_table, seed, LOG_BUCKET), values(n, seed + 1), n_table


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [2 * TILE + 5, 3 * TILE])
def test_model_of_the_partition_matches_add_at_and_xla(kind, n):
    # against float64 np.add.at, and XLA's f32 scatter-add within twice that
    # bound (both sum in f32): whole tiles and a short last tile
    idx, g, n_table = _case(kind, n)
    table = np.random.default_rng(62).normal(size=(n_table, 1)).astype(np.float32)
    got, keys, writes = model_partition(table, idx, g)
    assert (writes == 1).all() and sorted(keys.tolist()) == sorted(idx.tolist())  # each pair once, none lost
    exact = table.astype(np.float64)
    np.add.at(exact, idx, g.astype(np.float64))
    # I_TOL of the largest sum, plus the growth of f32 rounding over the m
    # updates of one entry in any order, 4 eps sqrt(m sum g^2) (the card's
    # test states the same bound)
    m = np.bincount(idx, minlength=n_table)
    s2 = np.bincount(idx, weights=g[:, 0].astype(np.float64) ** 2, minlength=n_table)
    tol = I_TOL * float(np.abs(exact).max()) + 4 * float(np.finfo(np.float32).eps) * float(np.sqrt(m * s2).max())
    assert float(np.abs(got - exact).max()) <= tol
    xla = np.asarray(jnp.asarray(table).at[jnp.asarray(idx)].add(jnp.asarray(g)))
    assert float(np.abs(got - xla).max()) <= 2 * tol
    untouched = np.setdiff1d(np.arange(n_table), idx)
    assert np.array_equal(got[untouched], table[untouched])  # entries no update reached stay as they were


def test_the_index_sets_are_what_they_say():
    n_table, bucket = (1 << 16) + 1000, 1 << LOG_BUCKET
    nb = -(-n_table // bucket)
    used = {k: np.unique(index_set(k, 1 << 14, n_table, 3, LOG_BUCKET) >> LOG_BUCKET) for k in KINDS}
    assert len(used["uniform"]) == nb and len(used["one_bucket"]) == 1 and len(used["one_index"]) == 1
    assert 0 < len(used["empty_buckets"]) <= (nb + 1) // 2 and 1 not in used["empty_buckets"]
    edge = index_set("bucket_boundary", 1 << 14, n_table, 3, LOG_BUCKET)
    assert set(np.unique(edge % bucket).tolist()) <= {0, bucket - 1, (n_table - 1) % bucket}
    assert n_table - 1 in edge and n_table % bucket != 0  # the last bucket is partial
    for k in KINDS:
        idx = index_set(k, 1000, n_table, 4, LOG_BUCKET)
        assert idx.dtype == np.int32 and idx.min() >= 0 and idx.max() < n_table


def test_the_model_sees_a_lost_reservation():
    # tiles that did not reserve their runs would write over each other's
    # pairs: the model's write count shows it
    idx, g, n_table = _case("uniform", 3 * TILE)
    table = np.zeros((n_table, 1), np.float32)
    with pytest.raises(AssertionError):
        model_partition(table, idx, g, reserve=False)
    _, _, writes = model_partition(table, idx, g)
    assert (writes == 1).all() and idx.shape[0] > 2 * TILE


def test_the_wrapper_threshold_matches_the_source():
    # the route and the scratch's size live in the kernel's source alone:
    # the wrapper passes the tensors, the binding sizes the scratch by the
    # source's function, which routes as the launcher does
    source, binding = SOURCE.read_text(), (cuda_lib.CSRC / "bindings.cpp").read_text()
    assert "cuda_lib.ops().scatter_add_rows(out, idx, g)\n" in inspect.getsource(gs.scatter_add_rows)
    assert not [name for name in vars(gs) if "PARTITION" in name.upper()]
    assert "void scatter_add_rows(const Tensor& out, const Tensor& idx, const Tensor& g) {" in binding
    assert "arcnerf_scatter_add_rows_scratch_bytes(out.size(0), static_cast<int>(w), idx.size(0))" in binding
    assert "long long arcnerf_scatter_add_rows_scratch_bytes(long long n_table, int w, long long n);" in (
        cuda_lib.CSRC / "launchers.h").read_text()
    size_fn = re.search(r'extern "C" long long arcnerf_scatter_add_rows_scratch_bytes\(.*?\n\}', source, re.S).group(0)
    launcher = re.search(r'extern "C" int arcnerf_scatter_add_rows\(.*?\n\}', source, re.S).group(0)
    for body in (size_fn, launcher):
        assert "partition_route(n_table, w, n)" in body
        assert "scratch_bytes<kLogBucket, kPartThreads * kPerThread>(n_table, n)" in body
    # the scratch holds the model's bound on the slots (n and a padding
    # update a tile and bucket), and the route keeps that bound in int32
    body = re.search(r"long long scratch_bytes\(long long n_table, long long n\) \{(.*?)\n\}", source, re.S).group(1)
    assert "units = (n + (n + TILE - 1) / TILE * nb + 1) / 2;" in body
    assert "return 4 * ((units + 1) / 2 * 2) + 8 * units + 12 * nb;" in body
    route = re.search(r"bool partition_route\(.*?\n\}", source, re.S).group(0)
    assert "n >= kPartitionMinUpdates && n_table >= kPartitionMinTable && nb <= kMaxBuckets" in route
    assert "n + (n + kTile - 1) / kTile * nb <= INT32_MAX" in route
    assert CONSTANTS["kMaxBuckets"] << LOG_BUCKET <= 1 << 31 and CONSTANTS["kPartitionMinUpdates"] < 1 << 31


def test_every_shared_scan_ends_with_a_barrier():
    # block_exclusive_scan's last loop writes entries other warps read
    # (above 1024 buckets a thread scans two), so it ends with a barrier
    body = re.search(r"__device__ void block_exclusive_scan\(.*?\n\}", SOURCE.read_text(), re.S).group(0)
    assert body.rstrip("}").rstrip().endswith("__syncthreads();")


def test_the_scatter_study_runs_on_the_card_only():
    from design_studies import scatter_designs

    with pytest.raises(RuntimeError, match="card only"):
        scatter_designs.main(["--device", "cpu"])
    names = set(re.findall(r'extern "C" int (design_\w+)\(', scatter_designs.SOURCE.read_text()))
    assert names == {"design_scatter", "design_dirty_shared"}
    for name in names:  # each typed before a call
        assert "lib.{}.argtypes = ".format(name) in inspect.getsource(scatter_designs.load)
