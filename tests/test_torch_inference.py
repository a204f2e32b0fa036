"""The port's Inferencer and ``python -m arcnerf_torch.inference`` (CPU):
camera paths and json paths against the JAX Inferencer's, the entry end
to end at 32x32 on a seeded checkpoint (mp4 through OpenCV, PNG frames
without it), and the refusals of the jobs not ported."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arcnerf_tpu.evaluation.infer_func import Inferencer as JaxInferencer
from arcnerf_tpu.utils.cfgs import dict_to_obj as jax_dict_to_obj
from arcnerf_torch.evaluation.infer_func import Inferencer, write_video
from arcnerf_torch.utils.cfgs import dict_to_obj
from tests.test_torch_slice import CFG, ROOT, SMALL

torch.set_num_threads(1)
INTRINSIC = np.array([[40.0, 0.0, 16.0], [0.0, 40.0, 16.0], [0.0, 0.0, 1.0]])
RENDER = {"type": ["circle", "spiral", "swing", "regular"], "n_cam": [4, 5, 3, 6], "radius": 2.5, "u_start": 0.1,
          "v_ratio": -0.2, "v_range": [-0.5, 0.0], "n_rot": 2, "fps": 5}


def test_camera_paths_equal_jax():
    ours = Inferencer(dict_to_obj({"render": RENDER}), INTRINSIC, (32, 24))
    theirs = JaxInferencer(jax_dict_to_obj({"render": RENDER}), INTRINSIC, (32, 24))
    assert [(j["mode"], len(j["cams"]), j["fps"]) for j in ours.render_data] == \
        [(j["mode"], len(j["cams"]), j["fps"]) for j in theirs.render_data]
    for job, job_j in zip(ours.render_data, theirs.render_data):
        for cam, cam_j in zip(job["cams"], job_j["cams"]):
            np.testing.assert_allclose(cam.get_pose(), cam_j.get_pose(as_jnp=False), atol=1e-12)
            assert cam.get_wh() == cam_j.get_wh() == (32, 24)
            ro, rd, _, _ = cam.get_rays(wh_order=False)
            ro_j, rd_j, _, _ = cam_j.get_rays(wh_order=False)
            np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
            np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)


def test_read_json_cam_equals_jax(tmp_path):
    c2ws = np.random.default_rng(0).normal(size=(3, 4, 4))
    for name, data in (("path.json", {"camera_path": [{"camera_to_world": m.reshape(-1).tolist()} for m in c2ws]}),
                       ("list.json", {"c2ws": c2ws.tolist()})):
        path = tmp_path / name
        path.write_text(json.dumps(data))
        got = Inferencer.read_json_cam(str(path))
        np.testing.assert_array_equal(got, JaxInferencer.read_json_cam(str(path)))
        np.testing.assert_array_equal(got, c2ws)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"poses": []}))
    with pytest.raises(ValueError):
        Inferencer.read_json_cam(str(bad))
    custom = Inferencer(dict_to_obj({"render": {"type": "custom", "custom_path": str(tmp_path / "list.json")}}),
                        INTRINSIC, (32, 32))
    assert len(custom.render_data[0]["cams"]) == 3
    np.testing.assert_array_equal(custom.render_data[0]["cams"][1].get_pose(), c2ws[1])


@pytest.mark.parametrize("cfgs,item", [
    ({"render": RENDER, "volume": {"n_grid": 64}}, "item 6"),
    ({"render": dict(RENDER, surface=True)}, "item 4"),
])
def test_unported_jobs_name_their_item(cfgs, item):
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1, {}\)$".format(item)):
        Inferencer(dict_to_obj(cfgs), INTRINSIC, (32, 32))


def seeded_checkpoint(path):
    """The small model of test_torch_slice with seeded weights and the
    spheres' occupancy, as a port checkpoint."""
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.models import build_model
    from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
    from arcnerf_torch.utils.model_io import save_model

    model = build_model(update_configs_by_dotlist(load_configs(CFG), list(SMALL)),
                        generator=torch.Generator().manual_seed(0))
    bound_state = model.init_bound_state()
    bound_state["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(16, 2.0))
    save_model(str(path), model.state_dict(), bound_state)


def inference_argv(ckpt, out_dir, n_cam=3):
    return ["--configs", CFG, "--model_pt", str(ckpt), "--device", "cpu", "--dir.eval_dir", str(out_dir),
            "--dataset.val.wh", "[32,32]", "--inference.render.type", "circle", "--inference.render.n_cam",
            str(n_cam), "--inference.render.radius", "2.5", "--inference.render.bkg_color", "[1.0,1.0,1.0]"] + SMALL


def test_inference_entry_renders_a_video(tmp_path):
    seeded_checkpoint(tmp_path / "ngp.pt")
    proc = subprocess.run([sys.executable, "-m", "arcnerf_torch.inference"]
                          + inference_argv(tmp_path / "ngp.pt", tmp_path / "out"),
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    video = tmp_path / "out" / "render_circle.mp4"
    assert "Inference done" in proc.stdout and video.exists() and video.stat().st_size > 0
    cv2 = pytest.importorskip("cv2")
    frames = []
    cap = cv2.VideoCapture(str(video))
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    assert len(frames) == 3 and frames[0].shape == (32, 32, 3)
    assert len({f.tobytes() for f in frames}) == 3  # the cameras move


def test_inference_writes_png_frames_without_opencv(tmp_path, monkeypatch):
    from arcnerf_torch import inference

    monkeypatch.setitem(sys.modules, "cv2", None)  # the import fails
    seeded_checkpoint(tmp_path / "ngp.pt")
    results = inference.main(inference_argv(tmp_path / "ngp.pt", tmp_path / "out", n_cam=2))
    assert results == {"video": [str(tmp_path / "out" / "render_circle")]}
    pngs = sorted(os.listdir(results["video"][0]))
    assert pngs == ["0000.png", "0001.png"]
    with open(os.path.join(results["video"][0], pngs[0]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    log = (tmp_path / "out" / "infer.log").read_text()
    assert "OpenCV is not installed: wrote 2 PNG frames" in log and "circle: 2 frames of 32x32, all finite True" in log


def test_write_video_without_opencv_numbers_its_frames(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = [np.full((4, 5, 3), v, np.float32) for v in (-1.0, 2.0)]
    out = write_video(str(tmp_path / "v.mp4"), frames)
    assert out == str(tmp_path / "v") and sorted(os.listdir(out)) == ["0000.png", "0001.png"]
