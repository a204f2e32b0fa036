"""The port's entry point vs the JAX package's on the same checkpoint (CPU):
a JAX checkpoint goes through scripts/export_jax_ckpt_to_torch.py, then
``arcnerf_torch.evaluate`` renders a 32x32 Synthetic eval view that the
repo's ``evaluate.py`` renders from the JAX checkpoint."""

import importlib.util
import os

import numpy as np
import torch

from arcnerf_tpu.utils.model_io import save_model as jax_save_model
from test_torch_slice import CFG, ROOT, SMALL, assert_slice_close, jax_model_and_params, sphere_bound_state

torch.set_num_threads(1)

# the evaluate.py user's flags: synthetic_ngp.yaml has no dataset.eval block.
# The budget 2^17 keeps the JAX path (8192-ray padded chunks x cap 16) clip-free.
EVAL = ["--configs", CFG, "--dataset.eval.type", "Synthetic", "--dataset.eval.n_imgs", "1",
        "--dataset.eval.wh", "[32,32]", "--dataset.eval.cam_radius", "2.5", "--dataset.eval.white_bkg", "True",
        "--dataset.eval.center_pixel", "True", "--progress.max_samples_eval", "1",
        "--model.obj_bound.eval_max_pts_per_ray", "16"]
ARGV = EVAL + SMALL + ["--model.obj_bound.log_max_allowance", "17"]


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_jax_ckpt_to_torch", os.path.join(ROOT, "scripts", "export_jax_ckpt_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_entry_matches_jax_on_an_exported_checkpoint(tmp_path, monkeypatch):
    import evaluate as jax_evaluate
    from arcnerf_torch import evaluate

    _, _, params = jax_model_and_params(ARGV[2:])
    jax_save_model(str(tmp_path / "jax"), {"params": params, "bound_state": sphere_bound_state()}, 0,
                   keep_name="final")
    jax_ckpt, port_ckpt = str(tmp_path / "jax" / "final.ckpt"), str(tmp_path / "port.pt")
    _export_script().main(ARGV[2:] + ["--model_pt", jax_ckpt, "--out", port_ckpt])

    summary, results = evaluate.main(ARGV + ["--model_pt", port_ckpt, "--device", "cpu",
                                             "--dir.eval_dir", str(tmp_path / "port_eval")])
    assert os.path.exists(tmp_path / "port_eval" / "eval_000.png") and np.isfinite(summary["psnr"])

    captured = {}
    run_eval = jax_evaluate.run_eval

    def capture(*args, **kwargs):
        captured["out"] = run_eval(*args, **kwargs)
        return captured["out"]

    monkeypatch.setattr(jax_evaluate, "run_eval", capture)
    monkeypatch.setattr("sys.argv", ["evaluate.py"] + ARGV + ["--model_pt", jax_ckpt,
                                                             "--dir.eval_dir", str(tmp_path / "jax_eval")])
    jax_evaluate.main()
    jax_summary, jax_results = captured["out"]

    got = {k: results[0][k] for k in ("rgb", "depth", "mask")}
    want = {k: np.asarray(jax_results[0][k]) for k in ("rgb", "depth", "mask")}
    assert got["rgb"].shape == want["rgb"].shape == (32, 32, 3)
    assert 0.05 < want["mask"].mean() < 0.95  # the spheres are in view
    assert_slice_close(got, want)
    assert abs(summary["psnr"] - jax_summary["psnr"]) < 0.05
