"""Camera poses on a sphere track, looking at a point (host-side numpy).

Counterpart of ``arcnerf_tpu/geometry/poses.py`` (view_matrix, look_at,
generate_cam_pose_on_sphere). Convention: c2w with columns (x, y, z, t);
y is up; the camera looks along +z.
"""

import numpy as np

from .sphere import get_regular_sphere_line, get_sphere_line, get_spiral_line, get_swing_line, uv_to_sphere_point


def _normalize(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)


def view_matrix(forward, cam_loc, up=np.array([0.0, 1.0, 0.0])):
    """c2w from forward dir + camera location. All np(3,) -> np(4, 4)."""
    rot_z = _normalize(forward)
    rot_x = _normalize(np.cross(up, rot_z))
    rot_y = _normalize(np.cross(rot_z, rot_x))
    mat = np.stack([rot_x, rot_y, rot_z, cam_loc], axis=-1)
    return np.concatenate([mat, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=-2)


def look_at(cam_loc, point, up=np.array([0.0, 1.0, 0.0])):
    """c2w placing the camera at cam_loc looking at point."""
    return view_matrix(_normalize(np.asarray(point) - np.asarray(cam_loc)), np.asarray(cam_loc), up)


def generate_cam_pose_on_sphere(
    mode,
    radius,
    n_cam,
    u_start=0,
    u_range=(0, 0.5),
    v_ratio=0,
    v_range=(1, 0),
    n_rot=3,
    reverse=False,
    upper=None,
    close=False,
    origin=(0, 0, 0),
    normal=(0.0, 1.0, 0.0),
    look_at_point=np.array([0.0, 0.0, 0.0]),
    rng=None,
):
    """Camera c2w poses on a sphere track, looking at a point.

    mode in {random, regular, circle, spiral, swing}. Returns (n_cam, 4, 4).
    """
    if mode == "random":
        rng = rng or np.random.default_rng(0)
        u = rng.random(n_cam) * np.pi * 2
        v = rng.random(n_cam) * np.pi
        xyz = uv_to_sphere_point(u, v, radius, origin)
    elif mode == "regular":
        xyz = get_regular_sphere_line(radius, u_start, origin, n_rot, n_pts=n_cam, upper=upper, close=close)
    elif mode == "circle":
        xyz = get_sphere_line(radius, u_start, v_ratio, origin, n_pts=n_cam, close=close)
    elif mode == "spiral":
        xyz = get_spiral_line(radius, u_start, v_range, origin, n_rot, n_pts=n_cam)
    elif mode == "swing":
        xyz = get_swing_line(radius, u_range, v_range, origin, n_rot, n_pts=n_cam, reverse=reverse)
    else:
        raise NotImplementedError("cam generation mode {} not supported".format(mode))

    normal = np.asarray(normal, dtype=np.float64)
    if not np.allclose(_normalize(normal), np.array([0.0, 1.0, 0.0])):
        # the track rotation to another up axis is not ported yet
        raise NotImplementedError("camera tracks around a normal other than +y")

    return np.stack([look_at(xyz[i], look_at_point) for i in range(xyz.shape[0])], axis=0)
