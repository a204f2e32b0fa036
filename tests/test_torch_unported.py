"""The port's trainer refuses the training options it has not ported yet,
naming the option and the ROADMAP Queue 1 item that ports it. CPU only; no
JAX."""

import os

import pytest

from arcnerf_torch.trainer import ArcNerfTrainer
from arcnerf_torch.trainer.trainer import _UNPORTED
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml")
SMALL = ["--device", "cpu", "--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
         "--model.obj_bound.volume.n_grid", "16", "--dataset.train.n_imgs", "1", "--dataset.train.wh", "[8,8]",
         "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[8,8]"]

# option -> (its dotlist, the ROADMAP Queue 1 item that ports it)
CASES = {
    "dist.model_parallel": (["--dist.model_parallel", "2"], "item 7"),
    "optim.clip_warmup": (["--optim.clip_warmup", "10"], "item 4"),
    "dataset.train.augmentation": (["--dataset.train.augmentation.shuffle", "True"], "item 4"),
    "viewer": (["--viewer", "True"], "item 6"),
}


def test_every_unported_option_has_a_case():
    assert sorted(".".join(path) for path, _, _ in _UNPORTED) == sorted(CASES)


@pytest.mark.parametrize("option", sorted(CASES))
def test_unported_option_names_itself_and_its_roadmap_item(option, tmp_path):
    extra, item = CASES[option]
    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL + extra + ["--dir.expr_dir", str(tmp_path / "x")])
    with pytest.raises(NotImplementedError) as err:
        ArcNerfTrainer(cfgs)
    message = str(err.value)
    assert message.startswith(option + " = ")
    assert message.endswith("(ROADMAP Queue 1, {})".format(item))
