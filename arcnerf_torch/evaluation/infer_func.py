"""Inference: novel-view videos on camera paths around the scene.

Counterpart of ``arcnerf_tpu/evaluation/infer_func.py`` (``write_video``,
``Inferencer``: ``set_render_data``, ``read_json_cam``, ``run_infer``,
``run_infer_render``). Every frame renders through
``RenderEngine.render_image`` on the engine's device. Where OpenCV is not
installed, a video is written as numbered PNG frames instead of an mp4.
The volume jobs (point cloud and mesh extraction) and the surface-render
video are not ported: configuring them raises NotImplementedError.
"""

import json
import os

import numpy as np

from ..geometry.poses import generate_cam_pose_on_sphere
from ..render.camera import PerspectiveCamera
from ..utils.cfgs import get_value_from_cfgs_field, valid_key_in_cfgs
from .eval_func import _write_png


def write_video(path, frames, fps=20, logger=None):
    """frames: list of (H, W, 3) float [0, 1] -> an mp4 at ``path`` through
    OpenCV, or, without OpenCV, PNG frames in the directory ``path``
    without its extension. Returns the path written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        out = os.path.splitext(path)[0]
        os.makedirs(out, exist_ok=True)
        for i, f in enumerate(frames):
            _write_png(os.path.join(out, "{:04d}.png".format(i)), (np.clip(f, 0, 1) * 255).astype(np.uint8))
        how = "OpenCV is not installed: wrote {} PNG frames to {}".format(len(frames), out)
    else:
        out = path
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            writer.write((np.clip(f, 0, 1) * 255).astype(np.uint8)[..., ::-1])
        writer.release()
        how = "wrote {} ({} frames, mp4)".format(out, len(frames))
    if logger is not None:
        logger.add_log(how)
    return out


class Inferencer:

    def __init__(self, cfgs, intrinsic, wh, logger=None):
        """cfgs: the ``inference`` cfg node; intrinsic (3, 3); wh (W, H)."""
        self.cfgs = cfgs
        self.logger = logger
        self.intrinsic = np.asarray(intrinsic)
        self.W, self.H = wh
        self.render_data = self.set_render_data()
        if valid_key_in_cfgs(cfgs, "volume"):
            raise NotImplementedError("inference.volume (point cloud and mesh extraction) is not ported yet "
                                      "(ROADMAP Queue 1, item 6)")

    # ------------------------------------------------------------ cam paths
    def set_render_data(self):
        """The camera-path cfgs -> a list of render jobs {mode, cams, fps,
        bkg_color}, or None without a render node."""
        if not valid_key_in_cfgs(self.cfgs, "render"):
            return None
        render_cfgs = self.cfgs.render
        if get_value_from_cfgs_field(render_cfgs, "surface", False):
            raise NotImplementedError("inference.render.surface (the surface-render video) is not ported yet "
                                      "(ROADMAP Queue 1, item 4)")
        types = get_value_from_cfgs_field(render_cfgs, "type", ["circle"])
        n_cam = get_value_from_cfgs_field(render_cfgs, "n_cam", [20])
        radius = get_value_from_cfgs_field(render_cfgs, "radius", 3.0)
        u_start = get_value_from_cfgs_field(render_cfgs, "u_start", 0.0)
        v_ratio = get_value_from_cfgs_field(render_cfgs, "v_ratio", 0.0)
        v_range = tuple(get_value_from_cfgs_field(render_cfgs, "v_range", [-0.5, 0.0]))
        n_rot = get_value_from_cfgs_field(render_cfgs, "n_rot", 3)
        fps = get_value_from_cfgs_field(render_cfgs, "fps", 20)
        bkg_color = get_value_from_cfgs_field(render_cfgs, "bkg_color", None)
        if not isinstance(types, list):
            types = [types]
        if not isinstance(n_cam, list):
            n_cam = [n_cam] * len(types)

        jobs = []
        for mode, n in zip(types, n_cam):
            if mode == "custom":
                c2ws = self.read_json_cam(get_value_from_cfgs_field(render_cfgs, "custom_path"))
                n = c2ws.shape[0]
            else:
                c2ws = generate_cam_pose_on_sphere(mode, radius, n, u_start=u_start, v_ratio=v_ratio, v_range=v_range,
                                                   n_rot=n_rot, close=True)
            cams = [PerspectiveCamera(self.intrinsic, c2ws[i], self.W, self.H) for i in range(n)]
            jobs.append({"mode": mode, "cams": cams, "fps": fps, "bkg_color": bkg_color})
        return jobs

    @staticmethod
    def read_json_cam(path):
        """A custom camera path from a json file, nerfstudio style
        ({'camera_path': [{'camera_to_world': [16 floats]}, ...]}) or a plain
        {'c2ws': [...]} list -> (N, 4, 4) float64."""
        with open(path) as f:
            data = json.load(f)
        if "camera_path" in data:
            mats = [np.asarray(c["camera_to_world"], dtype=np.float64).reshape(4, 4) for c in data["camera_path"]]
        elif "c2ws" in data:
            mats = [np.asarray(m, dtype=np.float64).reshape(4, 4) for m in data["c2ws"]]
        else:
            raise ValueError("unrecognized camera path json: {}".format(path))
        return np.stack(mats)

    # ------------------------------------------------------------- rendering
    def run_infer(self, engine, out_dir, chunk_rays=None):
        """Run every configured job through ``engine`` (a RenderEngine);
        writes into ``out_dir``. Returns {'video': [paths]}."""
        os.makedirs(out_dir, exist_ok=True)
        results = {}
        if self.render_data is not None:
            results["video"] = self.run_infer_render(engine, out_dir, chunk_rays)
        return results

    def run_infer_render(self, engine, out_dir, chunk_rays=None):
        """Render every camera of every job, then write each job's video."""
        paths = []
        for job in self.render_data:
            frames = []
            for cam in job["cams"]:
                ro, rd, _, _ = cam.get_rays(wh_order=False)
                sample = {"rays_o": ro, "rays_d": rd, "H": self.H, "W": self.W}
                imgs = engine.render_image(sample, chunk_rays, bkg_color=job["bkg_color"])
                frames.append(imgs["rgb"].float().cpu().numpy())
            if self.logger is not None:
                stack = np.stack(frames)
                self.logger.add_log("{}: {} frames of {}x{}, all finite {}, rgb in [{:.4f}, {:.4f}]".format(
                    job["mode"], len(frames), self.W, self.H, bool(np.isfinite(stack).all()), float(stack.min()),
                    float(stack.max())))
            path = os.path.join(out_dir, "render_{}.mp4".format(job["mode"]))
            paths.append(write_video(path, frames, job["fps"], self.logger))
        return paths
