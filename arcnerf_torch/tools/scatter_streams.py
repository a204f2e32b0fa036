"""Index sets for kernel I's W = 1 route (row scatter-add of single floats,
``csrc/scatter_add_rows.cu``), made with numpy from a seed: the
destination patterns its partition route (buckets of 2^``log_bucket``
entries) is tested on.

- ``uniform``: indices uniform over the table (kernel E's scale has ~4
  updates an entry);
- ``one_bucket``: every index in one bucket (one block sums them all);
- ``one_index``: every update to one entry;
- ``bucket_boundary``: the first and last entry of every bucket and the
  table's last entry (a table that does not fill its last bucket);
- ``empty_buckets``: every other bucket and a run of buckets left empty.

``partition_constants`` reads the route's bucket width, tile and thresholds
from the kernel's source, its one copy.
"""

import re
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "scatter_add_rows.cu"

KINDS = ("uniform", "one_bucket", "one_index", "bucket_boundary", "empty_buckets")


def index_set(kind, n, n_table, seed, log_bucket=13):
    """(n,) int32 indices in [0, n_table) of the named pattern."""
    rng = np.random.default_rng(seed)
    bucket = 1 << log_bucket
    n_buckets = -(-n_table // bucket)
    if kind == "uniform":
        idx = rng.integers(0, n_table, size=n)
    elif kind == "one_bucket":
        b = n_buckets // 2
        idx = b * bucket + rng.integers(0, min(bucket, n_table - b * bucket), size=n)
    elif kind == "one_index":
        idx = np.full(n, n_table // 3)
    elif kind == "bucket_boundary":
        edges = np.concatenate([np.arange(n_buckets) * bucket, np.minimum(np.arange(1, n_buckets + 1) * bucket,
                                                                          n_table) - 1, [n_table - 1]])
        idx = rng.choice(edges, size=n)
    elif kind == "empty_buckets":
        keep = np.arange(n_buckets)
        keep = keep[(keep % 2 == 0) & ((keep < n_buckets // 4) | (keep >= n_buckets // 2))]
        b = rng.choice(keep, size=n)
        idx = np.minimum(b * bucket + rng.integers(0, bucket, size=n), n_table - 1)
    else:
        raise ValueError("unknown index set {!r}; expected one of {}".format(kind, KINDS))
    return idx.astype(np.int32)


def values(n, seed):
    """(n, 1) f32 update values."""
    return np.random.default_rng(seed).normal(size=(n, 1)).astype(np.float32)


def partition_constants():
    """The kernel's namespace-level ``constexpr`` ints (``kLogBucket``,
    ``kPartThreads``, ``kPerThread``, ``kPartitionMinUpdates``, ...), each
    evaluated from those before it."""
    env = {}
    for name, expr in re.findall(r"^constexpr (?:int|long long) (\w+) = ([^;]+);", SOURCE.read_text(), re.M):
        env[name] = int(eval(expr.replace("1ll", "1"), {}, dict(env)))
    return env
