"""Camera-track line generators on a sphere (host-side numpy).

Counterpart of the track helpers of ``arcnerf_tpu/geometry/sphere.py``
that ``poses.generate_cam_pose_on_sphere`` uses. Convention: y is the
up/down axis; u in (0, 2pi) azimuth, v in (0, pi) polar.
"""

import math

import numpy as np


def uv_to_sphere_point(u, v, radius, origin=(0, 0, 0)):
    """u (n,), v (n,) or scalar -> xyz (n, 3) on the sphere."""
    u = np.asarray(u)
    if np.ndim(v) == 0:
        v = np.full_like(u, float(v))
    x = radius * (np.cos(u) * np.sin(v)) + origin[0]
    y = radius * np.cos(v) + origin[1]
    z = radius * (np.sin(u) * np.sin(v)) + origin[2]
    return np.stack([x, y, z], axis=-1)


def _wrap_u(u):
    u = u.copy()
    u[u > 1.0] -= 1.0
    return u


def get_regular_sphere_line(radius, u_start=0, origin=(0, 0, 0), n_rot=3, n_pts=100, upper=None, close=True):
    """n_rot stacked circles at regular heights, top to bottom."""
    assert 0 <= u_start <= 1
    n_per = math.ceil(float(n_pts) / float(n_rot))
    u = np.linspace(0, 1, n_per) if close else np.linspace(0, 1, n_per + 1)[:n_per]
    u = _wrap_u(u + u_start) * 2 * np.pi
    u = np.concatenate([u] * n_rot)[:n_pts]

    if upper is None:
        v_levels = np.linspace(-1, 1, n_rot + 2)[1:-1]
    elif upper:
        v_levels = np.linspace(-1, 0, n_rot + 1)[1:]
    else:
        v_levels = np.linspace(1, 0, n_rot + 1)[1:]
    v_levels = (1 - v_levels) * np.pi / 2.0

    lines, count = [], 0
    for i in range(n_rot - 1):
        lines.append(uv_to_sphere_point(u[count:count + n_per], v_levels[i], radius, origin))
        count += n_per
    lines.append(uv_to_sphere_point(u[count:], v_levels[-1], radius, origin))
    return np.concatenate(lines, axis=0)


def get_sphere_line(radius, u_start=0, v_ratio=0, origin=(0, 0, 0), n_pts=100, close=True):
    """One horizontal circle at height ratio v_ratio -> (n_pts, 3)."""
    assert 0 <= u_start <= 1 and -1 <= v_ratio <= 1
    u = np.linspace(0, 1, n_pts) if close else np.linspace(0, 1, n_pts + 1)[:n_pts]
    u = _wrap_u(u + u_start) * 2 * np.pi
    v = (1 - v_ratio) * np.pi / 2.0
    return uv_to_sphere_point(u, v, radius, origin)


def get_spiral_line(radius, u_start=0, v_range=(-1, 0), origin=(0, 0, 0), n_rot=3, n_pts=100):
    """Spiral from v_range[0] to v_range[1] over n_rot turns -> (n_pts, 3)."""
    assert 0 <= u_start <= 1
    n_per = math.ceil(float(n_pts) / float(n_rot))
    u = np.linspace(0, 1, n_per + 1)[:n_per]
    u = _wrap_u(u + u_start) * 2 * np.pi
    u = np.concatenate([u] * n_rot)[:n_pts]
    v = np.linspace(1 - v_range[0], 1 - v_range[1], n_pts) * np.pi / 2.0
    return uv_to_sphere_point(u, v, radius, origin)


def get_swing_line(radius, u_range=(0, 0.5), v_range=(-1, 0), origin=(0, 0, 0), n_rot=3, n_pts=100, reverse=False):
    """Back-and-forth arc swing while descending in v -> (n_pts, 3)."""
    assert 0 <= u_range[0] <= u_range[1] <= 1
    n_half = math.floor(float(n_pts) / float(n_rot) / 2.0 + 1)
    if reverse:
        u = np.linspace(u_range[1], 1 + u_range[0], n_half)
        u = _wrap_u(u)
        u = np.concatenate([u, np.flip(u)[1:-1]])
    else:
        u = np.linspace(u_range[0], u_range[1], n_half)
        u = np.concatenate([u, np.flip(u)[1:-1]])
    u = u * 2 * np.pi
    u = np.concatenate([u] * (n_rot + 1))[:n_pts]
    v = np.linspace(1 - v_range[0], 1 - v_range[1], n_pts) * np.pi / 2.0
    return uv_to_sphere_point(u, v, radius, origin)
