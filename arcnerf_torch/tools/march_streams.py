"""Compacted sample streams for kernels C and F (the compositing forward and
backward), made with numpy from a seed: the segment-length distributions
their tests hold them against.

A stream is what ``FgModel`` hands ``segment_march``: per ray an exclusive
start rank ``off`` and an in-stream count ``cnt`` over one (K,) stream of
sigma, (K, 3) rgb and z, ascending inside each segment on a fixed-step
ladder with gaps of 0 (crushed deltas), 1 or 2 steps. Rays past the budget
K keep their ``off`` and get ``cnt`` 0; the ray that crosses it is clipped.

- ``long_tail_lengths``: most rays short (0-32 samples, as the serving cap
  and most training rays give), some up to 512 (training has no per-ray
  cap), and the lengths at every chunk boundary of a 32-lane group (0, 1,
  31, 32, 33, 63, 64, 65, 511, 512).
"""

import numpy as np

BOUNDARY_LENGTHS = (0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 95, 96, 97, 511, 512)


def long_tail_lengths(n_rays, seed, max_len=512, tail=0.15):
    """(n_rays,) int64 segment lengths: 0-32 uniform, a ``tail`` share
    log-uniform in 33-``max_len``, and BOUNDARY_LENGTHS spread among them."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 33, size=n_rays)
    long = rng.random(n_rays) < tail
    n[long] = np.exp(rng.uniform(np.log(33), np.log(max_len + 1), size=int(long.sum()))).astype(np.int64)
    spots = rng.choice(n_rays, size=min(n_rays, len(BOUNDARY_LENGTHS)), replace=False)
    n[spots] = BOUNDARY_LENGTHS[:len(spots)]
    return np.minimum(n, max_len).astype(np.int64)


def segment_stream(lengths, k_total, seed, step=0.0068):
    """The stream of segments of ``lengths`` (N,) under a budget of
    ``k_total`` rows: sigma (K,), rgb (K, 3), z (K,) f32 and off, cnt (N,)
    int64. Rows past the segments are padding with arbitrary values."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    off = np.cumsum(lengths) - lengths
    cnt = np.minimum(np.maximum(k_total - off, 0), lengths)
    sigma = (rng.normal(size=k_total) * 20).astype(np.float32)
    rgb = rng.random((k_total, 3)).astype(np.float32)
    z = (2.0 + rng.random(k_total)).astype(np.float32)
    n_in = int(cnt.sum())
    ray = np.repeat(np.arange(len(lengths)), cnt)
    steps = np.cumsum(rng.integers(0, 3, size=n_in))
    z[:n_in] = (2.0 + step * (steps - steps[off[ray]])).astype(np.float32)
    return sigma, rgb, z, off, cnt


def ray_gradients(n_rays, seed):
    """The incoming gradients g_rgb (N, 3), g_depth, g_mask (N,) and a
    background (N, 3), f32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_rays, 3)).astype(np.float32), rng.normal(size=n_rays).astype(np.float32),
            rng.normal(size=n_rays).astype(np.float32), rng.random((n_rays, 3)).astype(np.float32))
