"""Point streams for kernel E (the hash-table scatter), made with numpy from
a seed: the orderings its card tests hold it against.

- ``ray_stream``: the training stream's order. The samples of a ray follow
  one another a fixed step apart along it (the recipe's 2 sqrt(3) / 512 in
  a volume of side 2), then the next ray's; 1 to ``max_per_ray`` samples a
  ray, so rays straddle warp boundaries.
- ``one_cell_stream``: every point inside one cell of level 0, the most
  adds on the fewest entries.
- ``pad_stream``: a stream compacted under a budget. The rows past the
  valid ones repeat row 0 and carry g = 0, as ``FgModel._compact_sel_aux``
  leaves them (``sel`` 0, sample 0 of ray 0).
"""

import math

import numpy as np

STEP = 2.0 * math.sqrt(3.0) / 512


def ray_stream(n_pts, seed, side=2.0, step=STEP, max_per_ray=32):
    """(n_pts, 3) f32 points inside the cube of ``side`` centred at 0, ray
    after ray, consecutive samples of a ray ``step`` apart."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_per_ray + 1, size=n_pts)
    n_rays = int(np.searchsorted(np.cumsum(counts), n_pts)) + 1
    counts = counts[:n_rays]
    ray = np.repeat(np.arange(n_rays), counts)[:n_pts]
    k = np.arange(n_pts) - (np.cumsum(counts) - counts)[ray]
    dirs = rng.normal(size=(n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    reach = side / 2 - (max_per_ray - 1) * step
    origins = rng.uniform(-reach, reach, size=(n_rays, 3))
    return (origins[ray] + (k * step)[:, None] * dirs[ray]).astype(np.float32)


def one_cell_stream(n_pts, seed, side=2.0, res=15, cell=(7, 7, 7)):
    """(n_pts, 3) f32 points inside cell ``cell`` of a level of resolution
    ``res`` (the recipe's level 0: 15), clear of its faces."""
    rng = np.random.default_rng(seed)
    width = side / res
    lower = -side / 2 + np.asarray(cell, np.float64) * width
    return (lower + rng.uniform(0.05, 0.95, size=(n_pts, 3)) * width).astype(np.float32)


def pad_stream(xyz, g, n_valid):
    """Copies of ``xyz`` (N, 3) and ``g`` (N, L F) as compaction leaves a
    budget of N rows with ``n_valid`` valid: rows from ``n_valid`` on
    repeat row 0 and carry g = 0."""
    xyz, g = xyz.copy(), g.copy()
    xyz[n_valid:] = xyz[0]
    g[n_valid:] = 0.0
    return xyz, g
